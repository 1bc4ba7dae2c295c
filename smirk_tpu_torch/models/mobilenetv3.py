"""MobileNetV3 "minimal" backbones in PyTorch (port of
smirk_tpu/models/mobilenetv3.py).

The two timm backbones the reference encoders use
(`tf_mobilenetv3_small_minimal_100`, `tf_mobilenetv3_large_minimal_100`):
ReLU everywhere, no squeeze-excite, 3x3 kernels, TF-style asymmetric SAME
padding and BN eps 1e-3. Batch norm (`BatchNorm2d`) follows Flax: in eval
mode it normalizes with the running stats; in train mode with the batch's,
and it updates the running stats as ra = 0.9 ra + 0.1 batch with the
BIASED batch variance (torch's own BatchNorm2d uses the unbiased one).

Compute dtype (the JAX package's `dtype=`, e.g. bf16 under
`arch.bf16_compute`): `forward(x, dtype)` casts the input at the stem, and
every layer below follows its input's dtype as Flax's cast points do: a
convolution casts its kernel to the input's dtype and returns that dtype;
batch norm takes its statistics from the input upcast to fp32, normalizes
in fp32 and casts the result back; ReLU and the residual add run in the
compute dtype. Parameters and running statistics stay fp32. With no
compute dtype every cast is skipped, so fp32 runs the same ops as before.

Stage tables are constructor arguments; `ARCHS` maps the timm names to
the published tables and is never written to. Module names follow timm's
(conv_stem, bn1, blocks.i.j.*), so a reference state dict loads as it is.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS_TF = 1e-3
BN_MOMENTUM = 0.9  # Flax's: ra = 0.9 ra + 0.1 batch
LOW_DTYPES = (torch.bfloat16, torch.float16)

Stage = Sequence[Tuple[str, int, int, int]]  # (block, exp_chs, out_chs, stride)

# expansion channel counts are timm's make_divisible(in_chs * exp_ratio, 8)
SMALL_MINIMAL: List[List[Tuple[str, int, int, int]]] = [
    [("ds", 16, 16, 2)],
    [("ir", 72, 24, 2), ("ir", 88, 24, 1)],
    [("ir", 96, 40, 2), ("ir", 240, 40, 1), ("ir", 240, 40, 1)],
    [("ir", 120, 48, 1), ("ir", 144, 48, 1)],
    [("ir", 288, 96, 2), ("ir", 576, 96, 1), ("ir", 576, 96, 1)],
    [("cn", 0, 576, 1)],
]

LARGE_MINIMAL: List[List[Tuple[str, int, int, int]]] = [
    [("ds", 16, 16, 1)],
    [("ir", 64, 24, 2), ("ir", 72, 24, 1)],
    [("ir", 72, 40, 2), ("ir", 120, 40, 1), ("ir", 120, 40, 1)],
    [("ir", 240, 80, 2), ("ir", 200, 80, 1), ("ir", 184, 80, 1), ("ir", 184, 80, 1)],
    [("ir", 480, 112, 1), ("ir", 672, 112, 1)],
    [("ir", 672, 160, 2), ("ir", 960, 160, 1), ("ir", 960, 160, 1)],
    [("cn", 0, 960, 1)],
]

ARCHS = {
    "tf_mobilenetv3_small_minimal_100": SMALL_MINIMAL,
    "tf_mobilenetv3_large_minimal_100": LARGE_MINIMAL,
}


def cast_to(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w in x's dtype (w itself when they agree: no op in fp32)."""
    return w if w.dtype == x.dtype else w.to(x.dtype)


class Conv2dSame(nn.Conv2d):
    """Bias-free conv with TF-style SAME padding (asymmetric: the extra
    row/column goes to the bottom/right)."""

    def __init__(self, in_chs, out_chs, kernel, stride=1, groups=1):
        super().__init__(in_chs, out_chs, kernel, stride, padding=0,
                         groups=groups, bias=False)

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        if ph or pw:
            x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, cast_to(self.weight, x), None, self.stride, 0, 1, self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same parameters, buffers and state-dict keys) with
    Flax's running-stat rule: in train mode the batch statistics normalize,
    and the running mean and variance move as ra = 0.9 ra + 0.1 batch,
    with the biased batch variance. num_batches_tracked stays unused.

    An input in a lower dtype is normalized in fp32 and the result cast
    back (Flax's _compute_stats / _normalize). Inside `frozen_stats()` the
    running statistics are not moved (a recomputed forward of a
    checkpointed region)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in LOW_DTYPES:
            return self.forward(x.float()).to(x.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_stats, "frozen", 0):
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        return y


_stats = threading.local()


@contextlib.contextmanager
def frozen_stats():
    """Within the block (on this thread) train-mode batch norm normalizes
    with the batch statistics but leaves the running ones as they are."""
    _stats.frozen = getattr(_stats, "frozen", 0) + 1
    try:
        yield
    finally:
        _stats.frozen -= 1


def _bn(c):
    return BatchNorm2d(c, eps=BN_EPS_TF)


class DepthwiseSeparable(nn.Module):
    """timm DepthwiseSeparableConv: dw3x3-BN-ReLU, pw1x1-BN (no act)."""

    def __init__(self, in_chs, out_chs, stride):
        super().__init__()
        self.conv_dw = Conv2dSame(in_chs, in_chs, 3, stride, groups=in_chs)
        self.bn1 = _bn(in_chs)
        self.conv_pw = Conv2dSame(in_chs, out_chs, 1)
        self.bn2 = _bn(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.relu(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """timm InvertedResidual: pw-BN-ReLU, dw-BN-ReLU, pwl-BN."""

    def __init__(self, in_chs, exp_chs, out_chs, stride):
        super().__init__()
        self.conv_pw = Conv2dSame(in_chs, exp_chs, 1)
        self.bn1 = _bn(exp_chs)
        self.conv_dw = Conv2dSame(exp_chs, exp_chs, 3, stride, groups=exp_chs)
        self.bn2 = _bn(exp_chs)
        self.conv_pwl = Conv2dSame(exp_chs, out_chs, 1)
        self.bn3 = _bn(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.relu(self.bn1(self.conv_pw(x)))
        y = F.relu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


class ConvBnAct(nn.Module):
    def __init__(self, in_chs, out_chs, stride):
        super().__init__()
        self.conv = Conv2dSame(in_chs, out_chs, 1, stride)
        self.bn1 = _bn(out_chs)

    def forward(self, x):
        return F.relu(self.bn1(self.conv(x)))


class MobileNetV3Features(nn.Module):
    """Backbone returning per-stage feature maps (timm features_only), NCHW."""

    def __init__(self, stages: Sequence[Stage]):
        super().__init__()
        self.conv_stem = Conv2dSame(3, 16, 3, 2)
        self.bn1 = _bn(16)
        blocks = nn.ModuleList()
        in_chs = 16
        for stage in stages:
            mods = nn.ModuleList()
            for btype, exp_chs, out_chs, stride in stage:
                if btype == "ds":
                    mods.append(DepthwiseSeparable(in_chs, out_chs, stride))
                elif btype == "ir":
                    mods.append(InvertedResidual(in_chs, exp_chs, out_chs, stride))
                elif btype == "cn":
                    mods.append(ConvBnAct(in_chs, out_chs, stride))
                else:
                    raise ValueError(f"unknown block type {btype!r}")
                in_chs = out_chs
            blocks.append(mods)
        self.blocks = blocks
        self.feature_dim = in_chs

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """NCHW input -> the stage outputs, in `dtype` when given."""
        if dtype is not None:
            x = x.to(dtype)
        x = F.relu(self.bn1(self.conv_stem(x)))
        feats = []
        for stage in self.blocks:
            for block in stage:
                x = block(x)
            feats.append(x)
        return feats
