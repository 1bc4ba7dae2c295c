"""Frozen copy of smirk_tpu_torch/render/camera.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

Orthographic camera projection (port of smirk_tpu/render/camera.py).

cam = [scale, tx, ty]; projection = scale * (xy + t), z passed through
scaled. The y/z sign flip of the reference renderer lives in
`orth_proj_ndc`.
"""
from __future__ import annotations

import torch


def batch_orth_proj(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """X (B,N,3), camera (B,3)=[scale,tx,ty] -> (B,N,3) scaled translation."""
    camera = camera.reshape(-1, 1, 3)
    xy = X[:, :, :2] + camera[:, :, 1:]
    Xt = torch.cat([xy, X[:, :, 2:]], dim=2)
    return camera[:, :, 0:1] * Xt


def orth_proj_ndc(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Project and flip y/z into SMIRK's custom NDC."""
    p = batch_orth_proj(X, camera)
    return torch.cat([p[..., :1], -p[..., 1:]], dim=-1)


def project_landmarks(lmk: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Landmarks -> 2D NDC (y flip, keep xy)."""
    p = batch_orth_proj(lmk, camera)
    return torch.cat([p[..., :1], -p[..., 1:2]], dim=-1)
