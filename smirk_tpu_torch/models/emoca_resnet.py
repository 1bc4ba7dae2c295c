"""EMOCA emotion-recognition ResNet50 backbone (port of
smirk_tpu/models/emoca_resnet.py; reference src/losses/resnet.py with
`emoca_specific=True`).

The bottleneck's stride sits on conv2 (the 3x3), not conv1, and the stem
max-pool pads by 1. Without the classifier the embedding is the global
mean of the stride-32 map (2048 channels; the reference's 7x7 average pool
at 224 px). The depth per stage is read from `LAYERS_R50` when a model is
built, so a test can build a reduced-depth twin. Parameters carry the
reference's names (`conv1`, `bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`,
...); `teachers.load_emotion_teacher` reads an EMOCA checkpoint's
`backbone.*` keys. Used frozen (eval mode) as the emotion-loss teacher.
"""
from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
LAYERS_R50 = [3, 4, 6, 3]


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=BN_EPS)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4, eps=BN_EPS)) if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class EmocaResNet50(nn.Module):
    """(B,H,W,3) NHWC images in [0, 1] -> (B, 2048) embeddings."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(
                zip([64, 128, 256, 512], LAYERS_R50, [1, 2, 2, 2])):
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(Bottleneck(inplanes, planes, s,
                                        bi == 0 and (s != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.eval()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(img.permute(0, 3, 1, 2)))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))


def emotion_embedding_distance(model: EmocaResNet50, gen: torch.Tensor, tar: torch.Tensor,
                               metric: str = "l2") -> torch.Tensor:
    """The expression loss's distance between the embeddings of the
    generated and the target images -> per-sample losses (B,); the
    gradient flows to `gen` only."""
    eg = model(gen)
    with torch.no_grad():
        et = model(tar)
    if metric == "l2":
        return ((eg - et) ** 2).mean(dim=1)
    if metric == "l1":
        return (eg - et).abs().mean(dim=1)
    if metric == "cos":
        num = (eg * et).sum(1)
        den = torch.linalg.vector_norm(eg, dim=1) * torch.linalg.vector_norm(et, dim=1)
        return 1.0 - num / den.clamp_min(1e-8)
    raise ValueError(metric)
