"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a call
counted on the reference, and the least time a raster could take on the
cell's projected faces.

The raster bounds count from the faces and the image size alone, so they
read the same whatever implements the raster (the arithmetic of
chip_smoke.py's `culled_bound` at commit 19e99aba3b04, with the
face-pixel pairs counted from each face's bounding box instead of from
the program's bins): 16 fp32 operations per (face, pixel) pair whose
pixel centre lies in the face's bounding box, 4 per value plane per
pixel, against the faces' vertices and attributes read once and the
outputs written once. Each bound is the larger of operations at the fp32
peak and bytes at the memory rate.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# one NVIDIA H100 SXM (data sheet, dense): fp32 outside the tensor cores,
# HBM3 bandwidth; both at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
OPS_PER_FACE_PIXEL = 16


def model_flops(fn: Callable[[], object]) -> Tuple[object, float]:
    """-> (fn(), the FLOPs torch.utils.flop_counter counts in it: the
    convolutions and matrix products of every forward and backward it
    runs, from their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, float(counter.get_total_flops())


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def box_pairs(face_verts: torch.Tensor, size: int) -> int:
    """(face, pixel) pairs whose pixel centre lies in the face's bounding
    box, over every image: face_verts (B,F,3,3) in NDC."""
    px = (face_verts[..., 0].double() * size + size - 1.0) / 2.0
    py = (face_verts[..., 1].double() * size + size - 1.0) / 2.0
    ncol = (px.amax(-1).floor().clamp(max=size - 1)
            - px.amin(-1).ceil().clamp(min=0) + 1).clamp_min(0)
    nrow = (py.amax(-1).floor().clamp(max=size - 1)
            - py.amin(-1).ceil().clamp(min=0) + 1).clamp_min(0)
    return int((ncol * nrow).sum())


def raster_forward(face_verts: torch.Tensor, size: int, D: int) -> Dict:
    """A z-buffered raster of D attribute planes: reads each face's 9
    vertex and 3D attribute floats, writes pix_to_face and D values."""
    B, F = face_verts.shape[:2]
    ops = box_pairs(face_verts, size) * OPS_PER_FACE_PIXEL + B * size * size * 4 * D
    nbytes = B * F * (9 + 3 * D) * 4 + (1 + D) * B * size * size * 4
    return {"ops": ops, "bytes": nbytes}


def raster_backward(face_verts: torch.Tensor, size: int, D: int) -> Dict:
    """The raster's backward to its planes: reads the D-channel cotangent
    and pix_to_face once, writes each face's 3D plane cotangents; 6D
    operations per pixel (the first moments g x, g y, g)."""
    B, F = face_verts.shape[:2]
    return {"ops": B * size * size * 6 * D,
            "bytes": B * size * size * (D + 1) * 4 + B * F * 3 * D * 4}


def total_bound(parts) -> Tuple[float, str]:
    """Sum of the parts' bounds -> (seconds, what bounds most of it)."""
    secs, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for p in parts:
        s, b = bound_s(p["ops"], p["bytes"])
        secs += s
        by[b] += s
    return secs, max(by, key=by.get)
