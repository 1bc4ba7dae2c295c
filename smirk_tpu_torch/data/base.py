"""Sample preparation: raw frame + landmarks -> fixed-shape training arrays
(port of smirk_tpu/data/base.py; numpy and the native host ops, it runs
in the loader's workers).

NHWC equivalent of the reference BaseDataset.prepare_data
(datasets/base_dataset.py:124-215): the landmark-driven crop (a random
scale in training), the convex-hull face mask, augmentation, landmarks
normalized to [-1, 1], and the ArcFace-aligned 112 px MICA crop.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from smirk_tpu_torch.data import transforms as T


def prepare_sample(
    rng: np.random.Generator,
    image: np.ndarray,  # (H,W,3) uint8 RGB
    landmarks_fan: Optional[np.ndarray],  # (68,2+) or None
    landmarks_mediapipe: np.ndarray,  # (478,2+) full mediapipe set
    image_size: int = 224,
    scale=1.6,
    test: bool = False,
) -> Dict[str, np.ndarray]:
    flag_fan = landmarks_fan is not None
    if landmarks_fan is None:
        landmarks_fan = np.zeros((68, 2), np.float32)
    landmarks_fan = np.asarray(landmarks_fan, np.float32)[:, :2]
    landmarks_mediapipe = np.asarray(landmarks_mediapipe, np.float32)[:, :2]

    if isinstance(scale, (list, tuple)):
        scale = rng.random() * (scale[1] - scale[0]) + scale[0]

    M = T.crop_face_tform(landmarks_mediapipe, scale, image_size)
    img = T.warp_affine_host(np.asarray(image, np.float32), M, (image_size, image_size))
    img = np.clip(img, 0, 255)
    lmk_fan = T.transform_points(M, landmarks_fan)
    lmk_mp = T.transform_points(M, landmarks_mediapipe)

    # augment in FACE polarity (1 = face) so the warp's zero border fill
    # stays background, as the reference flips for albumentations
    # (base_dataset.py:161,166); flipped back to the batch contract below
    hull_mask = 1.0 - T.convex_hull_mask_host(lmk_mp, (image_size, image_size))
    lmk_mp = lmk_mp[T.MEDIAPIPE_INDICES]

    img = (img / 255.0).astype(np.float32)
    if not test:
        img, hull_mask, lmk_fan, lmk_mp = T.augment(rng, img, hull_mask, lmk_fan, lmk_mp)

    lmk_fan = lmk_fan / image_size * 2 - 1
    lmk_mp = lmk_mp / image_size * 2 - 1

    # MICA input: ArcFace 5-point alignment on the ORIGINAL frame
    # (base_dataset.py:184-193); zeros when the FAN landmarks are missing
    if flag_fan:
        Ma = T.arcface_tform(landmarks_fan, 112)
        mica = T.warp_affine_host(
            np.asarray(image, np.float32) / 255.0, Ma, (112, 112)).astype(np.float32)
    else:
        mica = np.zeros((112, 112, 3), np.float32)

    return {
        "img": img,
        "landmarks_fan": lmk_fan.astype(np.float32),
        "flag_landmarks_fan": np.asarray(flag_fan),
        "landmarks_mp": lmk_mp.astype(np.float32),
        # 1 = background, 0 = face hull: the reference batch contract
        # (create_mask, base_dataset.py:9-15,210) that compose_mask expects
        "mask": (1.0 - hull_mask)[..., None].astype(np.float32),
        "img_mica": mica,
    }
