"""Frozen copy, the parts the reference uses, of
smirk_tpu_torch/models/encoders.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

SMIRK encoders: three independent CNN regressors over the same image
(port of smirk_tpu/models/encoders.py; reference src/smirk_encoder.py).

Pose -> 3 pose + 3 cam (cam-scale row zero, bias 7); Shape -> n_shape
(zero head); Expression -> n_exp + 2 eyelid (clamped [0,1]) + 3 jaw (relu,
clamp +-0.2). Images come in NHWC in [0,1], as in the JAX package, and are
permuted to NCHW here. `train()` / `eval()` switch every backbone's batch
norm between batch and running statistics (mobilenetv3.BatchNorm2d, Flax's
update rule). Module names follow the reference checkpoint
(`pose_encoder.encoder.conv_stem.weight`, `pose_encoder.pose_cam_layers.0`,
...), so `load_state_dict` takes a reference encoder state dict.
`forward(img, dtype)` runs the backbones in a compute dtype (bf16 under
`arch.bf16_compute`); the pooled features and the heads stay fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.mobilenetv3 import (
    LARGE_MINIMAL, SMALL_MINIMAL, MobileNetV3Features, Stage,
)


class _Regressor(nn.Module):
    """Backbone + global average pool + one linear head named `head_name`."""

    def __init__(self, stages: Sequence[Stage], head_name: str, head_dim: int):
        super().__init__()
        self.encoder = MobileNetV3Features(stages)
        self.head_name = head_name
        setattr(self, head_name,
                nn.Sequential(nn.Linear(self.encoder.feature_dim, head_dim)))

    def forward(self, x_nchw: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        # the heads stay fp32 for output precision
        f = self.encoder(x_nchw, dtype)[-1].float().mean(dim=(2, 3))
        return getattr(self, self.head_name)(f)


class SmirkEncoder(nn.Module):
    def __init__(
        self,
        n_exp: int = 50,
        n_shape: int = 300,
        pose_stages: Sequence[Stage] = SMALL_MINIMAL,
        shape_stages: Sequence[Stage] = LARGE_MINIMAL,
        expression_stages: Sequence[Stage] = LARGE_MINIMAL,
    ):
        super().__init__()
        self.n_exp = n_exp
        self.pose_encoder = _Regressor(pose_stages, "pose_cam_layers", 6)
        self.shape_encoder = _Regressor(shape_stages, "shape_layers", n_shape)
        self.expression_encoder = _Regressor(
            expression_stages, "expression_layers", n_exp + 2 + 3)
        self.eval()

    def forward(self, img: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """(B,S,S,3) NHWC in [0,1] -> the parameters (fp32); the backbones
        run in `dtype` when given."""
        x = img.permute(0, 3, 1, 2)  # NHWC -> NCHW
        pose_cam = self.pose_encoder(x, dtype)
        shape = self.shape_encoder(x, dtype)
        p = self.expression_encoder(x, dtype)
        n = self.n_exp
        return {
            "pose_params": pose_cam[..., :3],
            "cam": pose_cam[..., 3:],
            "shape_params": shape,
            "expression_params": p[..., :n],
            "eyelid_params": p[..., n:n + 2].clamp(0.0, 1.0),
            "jaw_params": torch.cat(
                [F.relu(p[..., n + 2:n + 3]), p[..., n + 3:n + 5].clamp(-0.2, 0.2)],
                dim=-1),
        }
