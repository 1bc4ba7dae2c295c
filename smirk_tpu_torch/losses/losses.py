"""Loss functions of the two training paths (port of
smirk_tpu/losses/losses.py)."""
from __future__ import annotations

import torch


def masked_landmark_mse(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor):
    """MSE over the first 17 FAN contour points of the samples with valid
    labels (`valid` (B,) bool); 0 when no sample is valid."""
    err = (pred[:, :17] - gt[:, :17]) ** 2  # (B,17,C)
    per_sample = err.mean(dim=(1, 2))
    v = valid.to(pred.dtype)
    denom = v.sum()
    return torch.where(denom > 0, (per_sample * v).sum() / denom.clamp_min(1), 0.0)


def landmark_mse(pred: torch.Tensor, gt: torch.Tensor):
    """Plain MSE."""
    return ((pred - gt) ** 2).mean()


def param_regularization(pred: torch.Tensor, base: torch.Tensor):
    """Mean squared deviation from a base prediction (or zeros)."""
    return ((pred - base) ** 2).mean()
