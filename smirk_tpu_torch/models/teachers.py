"""Frozen-teacher loaders (port of smirk_tpu/models/teachers.py): the
released checkpoints -> the port's teacher modules.

  * VGG16   -- a torchvision vgg16 state dict, bare or under `state_dict`
               (its `features.0` .. `features.21` keys; a dict of the
               `features` module alone, keys `0.weight` ..., also loads);
  * emotion -- an EMOCA ResNet50 checkpoint: `state_dict` with `backbone.*`
               keys (the classifier's are ignored);
  * MICA    -- `mica.tar`: `arcface` (the iresnet's state dict) and
               `flameModel`, whose `network` / `output` keys are the
               regressor's.

Each returns the module on `device`, in eval mode, with no parameter
requiring gradient; None when the path is empty or names no file (the
loss is then 0, as with a zero weight). A key the module needs and the
file lacks raises.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Mapping, Optional

import torch
from torch import nn

from smirk_tpu_torch.models.emoca_resnet import EmocaResNet50
from smirk_tpu_torch.models.mica import Mica
from smirk_tpu_torch.models.vgg import VGG16Features


def _load(path: str):
    """torch.load on the CPU, tensors only where the file allows it (a
    training checkpoint may pickle other objects beside its weights)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(f"{path} holds more than tensors; loading it with weights_only=False")
        return torch.load(path, map_location="cpu", weights_only=False)


def _absent(path: Optional[str]) -> bool:
    return not path or not os.path.isfile(path)


def freeze(module: Optional[nn.Module], device=None) -> Optional[nn.Module]:
    """module on `device`, in eval mode, with no parameter requiring
    gradient (None stays None)."""
    return None if module is None else module.to(device).eval().requires_grad_(False)


def frozen(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
           device=None) -> nn.Module:
    """module with the state dict's entries for its own keys (strict: a
    missing key raises), on `device`, in eval mode, frozen."""
    own = module.state_dict()
    module.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=True)
    return freeze(module, device)


def load_vgg_teacher(path: Optional[str], device=None) -> Optional[VGG16Features]:
    if _absent(path):
        return None
    sd = _load(path)
    sd = sd.get("state_dict", sd)
    if not any(k.startswith("features.") for k in sd):
        sd = {f"features.{k}": v for k, v in sd.items()}
    return frozen(VGG16Features(), sd, device)


def load_emotion_teacher(path: Optional[str], device=None) -> Optional[EmocaResNet50]:
    """The EMOCA emotion-recognition ResNet50 (the expression loss's backbone)."""
    if _absent(path):
        return None
    ckpt = _load(path)
    sd = ckpt.get("state_dict", ckpt)
    prefix = "backbone."
    return frozen(EmocaResNet50(),
                  {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, device)


def load_mica_teacher(path: Optional[str], device=None) -> Optional[Mica]:
    """mica.tar -> `Mica` (the arcface network and the regressor)."""
    if _absent(path):
        return None
    ckpt = _load(path)
    sd = {f"arcface.{k}": v for k, v in ckpt["arcface"].items()}
    for k, v in ckpt["flameModel"].items():
        if "network" in k or "output" in k:
            sd[f"regressor.{k.replace('regressor.', '')}"] = v
    return frozen(Mica(), sd, device)
