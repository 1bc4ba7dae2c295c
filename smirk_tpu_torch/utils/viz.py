"""Visualization artifacts: keypoint overlays + image grids (numpy; PIL
only in `save_image`). A copy of smirk_tpu/utils/viz.py.

Equivalent of the reference viz stack (base_trainer.py:130-224 +
utils/utils.py:65-90): per-batch jpg grids of [input+landmarks | render |
zero-pose render | masked | reconstruction | loss heatmap | cycle rows].
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def draw_keypoints(img: np.ndarray, landmarks: np.ndarray,
                   color=(0, 255, 0), radius: int = 1) -> np.ndarray:
    """img (H,W,3) float [0,1]; landmarks (K,2) in [-1,1] NDC."""
    out = (img * 255).clip(0, 255).astype(np.uint8).copy()
    H, W = out.shape[:2]
    # per-axis NDC -> pixel mapping (y scales with H, not W)
    pts = np.stack([landmarks[:, 0] * (W // 2) + W // 2,
                    landmarks[:, 1] * (H // 2) + H // 2], 1).astype(int)
    for x, y in pts:
        x0, x1 = max(0, x - radius), min(W, x + radius + 1)
        y0, y1 = max(0, y - radius), min(H, y + radius + 1)
        if x1 > x0 and y1 > y0:
            out[y0:y1, x0:x1] = color
    return out.astype(np.float32) / 255.0


def make_grid(images: np.ndarray, nrow: int = 1, pad: int = 2) -> np.ndarray:
    """(N,H,W,C) -> single grid image, column-major like torchvision."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    N, H, W, C = images.shape
    ncol = -(-N // nrow)
    grid = np.zeros((ncol * (H + pad) + pad, nrow * (W + pad) + pad, C),
                    np.float32)
    for i in range(N):
        r, c = divmod(i, nrow)
        y, x = pad + r * (H + pad), pad + c * (W + pad)
        grid[y:y + H, x:x + W] = images[i]
    return grid


def save_image(img: np.ndarray, path: str) -> None:
    from PIL import Image

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


# reference panel order (base_trainer.py:147-151 image_keys); '2nd_path'
# renders one row of 4*Ke quadruple panels per sample
PANEL_KEYS = (
    "img_mica", "rendered_img_base", "rendered_img",
    "overlap_image", "overlap_image_pixels",
    "rendered_img_mica_zero", "rendered_img_zero",
    "masked_img", "reconstructed_img", "loss_img",
    "2nd_path",
)


def training_grid(
    batch: Dict[str, np.ndarray],
    outputs: Dict[str, np.ndarray],
    show_landmarks: bool = True,
) -> np.ndarray:
    """Side-by-side panel per sample (reference save_visualizations,
    base_trainer.py:130-162): input (optionally with the 4-color landmark
    overlay), then the image_keys panels that are present, then the
    cycle-path quadruple rows."""
    img = np.asarray(batch["img"])
    B = img.shape[0]
    outputs = dict(outputs)
    if outputs.get("rendered_img") is not None:
        outputs["overlap_image"] = 0.7 * img + 0.3 * np.asarray(
            outputs["rendered_img"])
    if outputs.get("masked_img") is not None:
        outputs["overlap_image_pixels"] = 0.7 * img + 0.3 * np.asarray(
            outputs["masked_img"])

    cols: List[np.ndarray] = []
    if show_landmarks and outputs.get("landmarks_mp") is not None:
        # 4 colors as base_trainer.py:138-142: predicted mp green, gt mp
        # blue, predicted fan jawline magenta, gt fan jawline white
        overlaid = []
        for i, im in enumerate(img):
            im = draw_keypoints(im, np.asarray(outputs["landmarks_mp"])[i],
                                (0, 255, 0))
            if batch.get("landmarks_mp") is not None:
                im = draw_keypoints(im, np.asarray(batch["landmarks_mp"])[i],
                                    (0, 0, 255))
            if outputs.get("landmarks_fan") is not None:
                im = draw_keypoints(
                    im, np.asarray(outputs["landmarks_fan"])[i][:17],
                    (255, 0, 255))
            if batch.get("landmarks_fan") is not None:
                im = draw_keypoints(
                    im, np.asarray(batch["landmarks_fan"])[i][:17, :2],
                    (255, 255, 255))
            overlaid.append(im)
        cols.append(make_grid(np.stack(overlaid)))
    else:
        cols.append(make_grid(img))

    for key in PANEL_KEYS:
        val = outputs.get(key)
        if val is None:
            continue
        val = np.asarray(val)
        nrow = 1 if key != "2nd_path" else max(1, val.shape[0] // B)
        cols.append(make_grid(val, nrow=nrow))

    h = max(c.shape[0] for c in cols)
    cols = [
        np.pad(c, ((0, h - c.shape[0]), (0, 0), (0, 0))) for c in cols
    ]
    return np.concatenate(cols, axis=1)
