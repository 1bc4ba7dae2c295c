"""MICA shape teacher (port of smirk_tpu/models/mica.py; reference
src/models/MICA/{mica.py,arcface.py}): an ArcFace iresnet100 embedding ->
`MappingNetwork` -> 300 FLAME shape parameters.

Input is the 112 px ArcFace-aligned crop, NHWC in [0, 1], mapped to
(x - 0.5) / 0.5 and flipped RGB -> BGR. The iresnet's basic blocks are
BN-first with per-channel PReLU and stride 2 on every stage's first block;
the stem is a 3x3 stride-1 convolution; the head is BatchNorm2d -> flatten
(CHW order, natural in NCHW) -> fc (512 * 7 * 7 -> 512, so 112 px only) ->
BatchNorm1d `features` (its scale frozen at 1 in the reference). The
embedding is L2-normalized (floor 1e-12) and mapped by 4 linear layers with
leaky ReLU (slope 0.2) and an output layer. The depth per stage is read
from `IRESNET100_LAYERS` when a model is built. Parameters carry the
reference's names under `arcface.` and `regressor.`
(`teachers.load_mica_teacher` reads `mica.tar`). Used frozen, in eval mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
IRESNET100_LAYERS = [3, 13, 30, 3]
MICA_SIZE = 112


class IBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=BN_EPS)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False),
            nn.BatchNorm2d(planes, eps=BN_EPS)) if downsample else None)

    def forward(self, x):
        out = self.bn2(self.conv1(self.bn1(x)))
        out = self.bn3(self.conv2(self.prelu(out)))
        return out + (x if self.downsample is None else self.downsample(x))


class ArcFaceIResNet100(nn.Module):
    """NCHW (B,3,112,112) -> (B, num_features) (before normalization)."""

    def __init__(self, num_features: int = 512):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512], IRESNET100_LAYERS)):
            layer = []
            for bi in range(blocks):
                s = 2 if bi == 0 else 1
                layer.append(IBasicBlock(inplanes, planes, s,
                                         bi == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.bn2 = nn.BatchNorm2d(512, eps=BN_EPS)
        side = MICA_SIZE // 16
        self.fc = nn.Linear(512 * side * side, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=BN_EPS)
        nn.init.constant_(self.features.weight, 1.0)
        self.features.weight.requires_grad_(False)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return self.features(self.fc(self.bn2(x).flatten(1)))


class MappingNetwork(nn.Module):
    """MICA's regressor: hidden + 1 linear layers with leaky ReLU (0.2),
    then the output layer (no skips for hidden <= 5)."""

    def __init__(self, z_dim: int = 512, hidden_dim: int = 300, out_dim: int = 300,
                 hidden: int = 3):
        super().__init__()
        self.network = nn.ModuleList(
            [nn.Linear(z_dim, hidden_dim)]
            + [nn.Linear(hidden_dim, hidden_dim) for _ in range(hidden)])
        self.output = nn.Linear(hidden_dim, out_dim)

    def forward(self, z):
        h = z
        for layer in self.network:
            h = F.leaky_relu(layer(h), negative_slope=0.2)
        return self.output(h)


class Mica(nn.Module):
    """(B,112,112,3) NHWC images in [0, 1] -> (B, 300) shape parameters."""

    def __init__(self):
        super().__init__()
        self.arcface = ArcFaceIResNet100()
        self.regressor = MappingNetwork()
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = ((images - 0.5) / 0.5).flip(-1)  # RGB -> BGR
        emb = self.arcface(x.permute(0, 3, 1, 2))
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-12)
        return self.regressor(emb)
