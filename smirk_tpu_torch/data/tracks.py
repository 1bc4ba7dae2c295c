"""Per-frame landmark track utilities (a copy of smirk_tpu/data/tracks.py;
reference data_utils.py:65-100)."""
from __future__ import annotations

from typing import List, Optional


def linear_interpolate(landmarks, start_idx, stop_idx):
    start, stop = landmarks[start_idx], landmarks[stop_idx]
    delta = stop - start
    for idx in range(1, stop_idx - start_idx):
        landmarks[start_idx + idx] = (
            start + idx / float(stop_idx - start_idx) * delta
        )
    return landmarks


def landmarks_interpolate(landmarks: List) -> Optional[List]:
    """Fill gaps in a per-frame landmark track; None if all frames empty."""
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not valid:
        return None
    for j in range(1, len(valid)):
        if valid[j] - valid[j - 1] != 1:
            landmarks = linear_interpolate(landmarks, valid[j - 1], valid[j])
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    landmarks[: valid[0]] = [landmarks[valid[0]]] * valid[0]
    landmarks[valid[-1]:] = [landmarks[valid[-1]]] * (len(landmarks) - valid[-1])
    if any(lm is None for lm in landmarks):
        raise ValueError("landmark track still has gaps after interpolation")
    return landmarks
