"""Fuse generator: UNet (4 down / 4 up, skip concat) + reflect-pad ResNet
blocks at the bottleneck, sigmoid output (port of
smirk_tpu/models/generator.py; reference src/smirk_generator.py).

Input is [render | masked image], NHWC with 6 channels; output NHWC with 3
channels in (0, 1). Module names follow the reference checkpoint
(`encoder1.enc1conv1.weight`, `resnet_blocks.0.conv_block.1.weight`,
`upconv4.weight`, `conv.bias`), so `load_state_dict` takes a reference
generator state dict. Batch norm has eps 1e-5 and Flax's running-stat rule
(mobilenetv3.BatchNorm2d): train mode normalizes with the batch statistics
and moves the running ones by 0.1 toward them, biased variance.

`forward(x, dtype)` runs the UNet in a compute dtype (bf16 under
`arch.bf16_compute`) as the JAX package does: the input is cast at the top;
convolutions, transposed convolutions, pools, pads and concatenations run
in it (kernels and biases cast to it); batch norm in fp32 on the upcast
input, cast back; the 1x1 output head and the sigmoid in fp32.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from smirk_tpu_torch.models.mobilenetv3 import BatchNorm2d, cast_to

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters and keys) in its input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else cast_to(self.bias, x)
        return self._conv_forward(x, cast_to(self.weight, x), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (same parameters and keys) in its input's dtype."""

    def forward(self, x):
        return F.conv_transpose2d(x, cast_to(self.weight, x), cast_to(self.bias, x),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def _block(in_c: int, feat: int, name: str) -> nn.Sequential:
    """(conv3x3 no bias, BN, ReLU) x 2, named as the reference's blocks."""
    return nn.Sequential(OrderedDict([
        (name + "conv1", Conv2d(in_c, feat, 3, padding=1, bias=False)),
        (name + "norm1", BatchNorm2d(feat, eps=BN_EPS)),
        (name + "relu1", nn.ReLU(inplace=True)),
        (name + "conv2", Conv2d(feat, feat, 3, padding=1, bias=False)),
        (name + "norm2", BatchNorm2d(feat, eps=BN_EPS)),
        (name + "relu2", nn.ReLU(inplace=True)),
    ]))


class ResnetBlock(nn.Module):
    """x + (reflect pad, conv3x3, BN, ReLU, reflect pad, conv3x3, BN)(x)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1),
            Conv2d(dim, dim, 3, bias=False),
            BatchNorm2d(dim, eps=BN_EPS),
            nn.ReLU(inplace=True),
            nn.ReflectionPad2d(1),
            Conv2d(dim, dim, 3, bias=False),
            BatchNorm2d(dim, eps=BN_EPS),
        )

    def forward(self, x):
        return x + self.conv_block(x)


class SmirkGenerator(nn.Module):
    def __init__(self, in_channels: int = 6, out_channels: int = 3,
                 init_features: int = 32, res_blocks: int = 5):
        super().__init__()
        f = init_features
        self.encoder1 = _block(in_channels, f, "enc1")
        self.encoder2 = _block(f, f * 2, "enc2")
        self.encoder3 = _block(f * 2, f * 4, "enc3")
        self.encoder4 = _block(f * 4, f * 8, "enc4")
        self.pool = nn.MaxPool2d(2, 2)
        self.bottleneck = _block(f * 8, f * 16, "bottleneck")
        self.resnet_blocks = nn.ModuleList(ResnetBlock(f * 16) for _ in range(res_blocks))
        self.upconv4 = ConvTranspose2d(f * 16, f * 8, 2, 2)
        self.decoder4 = _block(f * 16, f * 8, "dec4")
        self.upconv3 = ConvTranspose2d(f * 8, f * 4, 2, 2)
        self.decoder3 = _block(f * 8, f * 4, "dec3")
        self.upconv2 = ConvTranspose2d(f * 4, f * 2, 2, 2)
        self.decoder2 = _block(f * 4, f * 2, "dec2")
        self.upconv1 = ConvTranspose2d(f * 2, f, 2, 2)
        self.decoder1 = _block(f * 2, f, "dec1")
        self.conv = nn.Conv2d(f, out_channels, 1)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Seeded random init as Flax's defaults: lecun-normal kernels (fan
        in = in channels x kernel area; for a transposed conv, its input
        channels), zero biases, identity batch norm."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        .mul_(1.0 / math.sqrt(fan_in)).to(w))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B,H,W,6) NHWC -> (B,H,W,3) NHWC in (0, 1), fp32; the UNet runs
        in `dtype` when given."""
        x = x.permute(0, 3, 1, 2)
        if dtype is not None:
            x = x.to(dtype)
        e1 = self.encoder1(x)
        e2 = self.encoder2(self.pool(e1))
        e3 = self.encoder3(self.pool(e2))
        e4 = self.encoder4(self.pool(e3))
        b = self.bottleneck(self.pool(e4))
        for block in self.resnet_blocks:
            b = block(b)
        d4 = self.decoder4(torch.cat([self.upconv4(b), e4], dim=1))
        d3 = self.decoder3(torch.cat([self.upconv3(d4), e3], dim=1))
        d2 = self.decoder2(torch.cat([self.upconv2(d3), e2], dim=1))
        d1 = self.decoder1(torch.cat([self.upconv1(d2), e1], dim=1))
        # the output head in fp32: the image feeds fp32 losses
        return torch.sigmoid(self.conv(d1.float())).permute(0, 2, 3, 1)
