"""MobileNetV3 "minimal" backbones in PyTorch (port of
smirk_tpu/models/mobilenetv3.py).

The two timm backbones the reference encoders use
(`tf_mobilenetv3_small_minimal_100`, `tf_mobilenetv3_large_minimal_100`):
ReLU everywhere, no squeeze-excite, 3x3 kernels, TF-style asymmetric SAME
padding and BN eps 1e-3. Batch norm runs in eval mode (running stats).

Stage tables are constructor arguments; `ARCHS` maps the timm names to
the published tables and is never written to. Module names follow timm's
(conv_stem, bn1, blocks.i.j.*), so a reference state dict loads as it is.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS_TF = 1e-3

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
        return F.conv2d(x, self.weight, None, self.stride, 0, 1, self.groups)


def _bn(c):
    return nn.BatchNorm2d(c, eps=BN_EPS_TF)


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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv_stem(x)))
        feats = []
        for stage in self.blocks:
            for block in stage:
                x = block(x)
            feats.append(x)
        return feats
