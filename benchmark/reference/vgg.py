"""Frozen copy of smirk_tpu_torch/models/vgg.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

VGG16 feature blocks for the perceptual loss (port of
smirk_tpu/models/vgg.py; reference src/losses/VGGPerceptualLoss.py).

Four torchvision vgg16 feature slices ([:4], [4:9], [9:16], [16:23]); the
loss sums the mean absolute difference of the block activations. Inputs
(NHWC in [0, 1]) go through the reference's chain x * 0.5 + 0.5, then the
ImageNet normalization, then a bilinear resize to 224 px
(`resize_bilinear`, jax.image.resize's half-pixel rule, antialiased when
it shrinks). Parameters carry torchvision's names (`features.0.weight`,
..., `features.21.bias`), so a torchvision vgg16 state dict restricted to
these keys loads with strict=True (`teachers.load_vgg_teacher`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_SIZE = 224

# torchvision vgg16 `features` conv indices per perceptual block
VGG16_BLOCK_CONVS = [
    [(0, 64), (2, 64)],
    [(5, 128), (7, 128)],
    [(10, 256), (12, 256), (14, 256)],
    [(17, 512), (19, 512), (21, 512)],
]


class VGG16Features(nn.Module):
    """torchvision vgg16 `features[:23]`, returning the four block
    activations (NCHW) the perceptual loss compares. Layers keep
    torchvision's indices as their names, read from `VGG16_BLOCK_CONVS`
    when the model is built (a test may patch a smaller table)."""

    def __init__(self):
        super().__init__()
        layers, self.block_ends = OrderedDict(), []
        in_ch = 3
        for bi, block in enumerate(VGG16_BLOCK_CONVS):
            if bi > 0:
                layers[str(block[0][0] - 1)] = nn.MaxPool2d(2, 2)
            for idx, ch in block:
                layers[str(idx)] = nn.Conv2d(in_ch, ch, 3, padding=1)
                layers[str(idx + 1)] = nn.ReLU()
                in_ch = ch
            self.block_ends.append(str(block[-1][0] + 1))
        self.features = nn.Sequential(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for name, layer in self.features.named_children():
            x = layer(x)
            if name in self.block_ends:
                feats.append(x)
        return feats


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B,H,W,C) -> (B,size,size,C), as jax.image.resize(..., "bilinear"):
    half-pixel centres, a triangle filter widened by the scale when it
    shrinks (antialiasing)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=size < max(x.shape[1:3]))
    return y.permute(0, 2, 3, 1)


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """The reference's input chain, NHWC [0, 1] -> NCHW at 224 px."""
    x = x * 0.5 + 0.5
    x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    if x.shape[1] != VGG_SIZE:
        x = resize_bilinear(x, VGG_SIZE)
    return x.permute(0, 3, 1, 2)


def perceptual_loss(vgg: VGG16Features, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over the four blocks of the mean absolute feature difference;
    the gradient flows to x only (y is the target image)."""
    fx = vgg(preprocess(x))
    with torch.no_grad():
        fy = vgg(preprocess(y))
    return sum((a - b).abs().mean() for a, b in zip(fx, fy))
