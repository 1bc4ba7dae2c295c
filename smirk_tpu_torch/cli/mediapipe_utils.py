"""Mediapipe face landmarker wrapper (a copy of
smirk_tpu/cli/mediapipe_utils.py).

Host-side. Requires the mediapipe package (imported at the first
detection) and the face_landmarker.task asset; both are optional: the
demos accept precomputed landmark files instead.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

_detector = None


def _get_detector():
    global _detector
    if _detector is None:
        import mediapipe as mp
        from mediapipe.tasks import python as mp_python
        from mediapipe.tasks.python import vision

        task_path = os.environ.get(
            "SMIRK_FACE_LANDMARKER", "assets/face_landmarker.task"
        )
        base_options = mp_python.BaseOptions(model_asset_path=task_path)
        options = vision.FaceLandmarkerOptions(
            base_options=base_options,
            output_face_blendshapes=False,
            output_facial_transformation_matrixes=False,
            num_faces=1,
            min_face_detection_confidence=0.1,
            min_face_presence_confidence=0.1,
        )
        _detector = (vision.FaceLandmarker.create_from_options(options), mp)
    return _detector


def run_mediapipe(image: np.ndarray) -> Optional[np.ndarray]:
    """RGB uint8 (H,W,3) -> (478,3) pixel-space landmarks or None."""
    detector, mp = _get_detector()
    # mp.Image requires C-contiguous uint8; callers often pass BGR->RGB views
    image = np.ascontiguousarray(image, dtype=np.uint8)
    mp_img = mp.Image(image_format=mp.ImageFormat.SRGB, data=image)
    res = detector.detect(mp_img)
    if not res.face_landmarks:
        return None
    lm = res.face_landmarks[0]
    H, W = image.shape[:2]
    return np.array([[p.x * W, p.y * H, p.z] for p in lm], np.float32)
