"""Seeded weights, made on the device in a few large calls.

Each module's state dict is laid out from the reference's module classes
(the program's modules carry the same names and shapes), and every
random leaf is a slice of one normal draw from a `torch.Generator` on the
device seeded with --seed, scaled per leaf. The same dict is loaded into
the program and into the reference.

Recipes (the configuration files' `assumed`): convolutions lecun-normal
(std 1 / sqrt(fan in); a transposed convolution's fan in is its input
channels times its kernel area) times a gain, batch norm the identity
(weight 1, bias 0, running mean 0, running variance 1), linear layers
lecun-normal with zero bias, PReLU 0.25. The encoder heads as the
program's init: the pose head x0.001 with its cam-scale row zero and the
bias 7 there, the expression head x0.1; the shape head x0.1 (the program
zeroes it, which would leave shape out of FLAME).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from benchmark.reference.encoders import SmirkEncoder
from benchmark.reference.generator import SmirkGenerator
from benchmark.reference.mica import Mica
from benchmark.reference.mobilenetv3 import ARCHS
from benchmark.reference.vgg import VGG16Features

# leaf -> (fan in, gain) of every random leaf; the rest are set below
Plan = Dict[str, Tuple[int, float]]


def _plan(module: nn.Module, conv_gain: float) -> Tuple[Plan, Dict[str, float]]:
    """-> (random leaves {name: (fan in, gain)}, constant leaves {name: value})."""
    rand, const = {}, {}
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, nn.ConvTranspose2d):
            w = m.weight
            rand[pre + "weight"] = (w.shape[0] * w.shape[2] * w.shape[3], conv_gain)
        elif isinstance(m, nn.Conv2d):
            rand[pre + "weight"] = (m.weight[0].numel(), conv_gain)
        elif isinstance(m, nn.Linear):
            rand[pre + "weight"] = (m.weight.shape[1], 1.0)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            const.update({pre + "weight": 1.0, pre + "bias": 0.0, pre + "running_mean": 0.0,
                          pre + "running_var": 1.0, pre + "num_batches_tracked": 0.0})
            continue
        elif isinstance(m, nn.PReLU):
            const[pre + "weight"] = 0.25
            continue
        else:
            continue
        if getattr(m, "bias", None) is not None:
            const[pre + "bias"] = 0.0
    return rand, const


def _fill(module: nn.Module, conv_gain: float, gen: torch.Generator, device,
          head_gains: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """The module's state dict on `device`: one normal draw for all its
    random leaves, sliced and scaled."""
    shapes = {k: (v.shape, v.dtype) for k, v in module.state_dict().items()}
    rand, const = _plan(module, conv_gain)
    for name, gain in (head_gains or {}).items():
        rand[name] = (rand[name][0], gain)
    total = sum(math.prod(shapes[k][0]) for k in rand)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (fan_in, gain) in rand.items():
        n = math.prod(shapes[name][0])
        out[name] = flat[at:at + n].view(shapes[name][0]) * (gain / math.sqrt(fan_in))
        at += n
    for name, value in const.items():
        shape, dtype = shapes[name]
        out[name] = torch.full(shape, value, dtype=dtype, device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise KeyError(f"no recipe for {sorted(missing)}")
    return out


def encoder_module(cfg) -> SmirkEncoder:
    arch = cfg["arch"]
    return SmirkEncoder(n_exp=arch["num_expression"], n_shape=arch["num_shape"],
                        pose_stages=ARCHS[arch["backbone_pose"]],
                        shape_stages=ARCHS[arch["backbone_shape"]],
                        expression_stages=ARCHS[arch["backbone_expression"]])


def make(cfg, seed: int, device, teachers: Iterable[str] = None) -> Dict[str, Dict]:
    """-> {"encoder", ["generator"], ["vgg"], ["mica"]: state dict}, from
    --seed on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        encoder = encoder_module(cfg)
    heads = {"pose_encoder.pose_cam_layers.0.weight": 0.001,
             "shape_encoder.shape_layers.0.weight": 0.1,
             "expression_encoder.expression_layers.0.weight": 0.1}
    out = {"encoder": _fill(encoder, 1.0, gen, device, heads)}
    pose_w = out["encoder"]["pose_encoder.pose_cam_layers.0.weight"]
    pose_w[3] = 0.0
    out["encoder"]["pose_encoder.pose_cam_layers.0.bias"][3] = 7.0
    if cfg["arch"]["enable_fuse_generator"]:
        with torch.device("meta"):
            g = SmirkGenerator(6, 3, cfg["generator_features"], cfg["generator_res_blocks"])
        out["generator"] = _fill(g, 1.0, gen, device)
    teachers = cfg["teachers"] if teachers is None else teachers
    if "vgg" in teachers:
        with torch.device("meta"):
            vgg = VGG16Features()
        out["vgg"] = _fill(vgg, math.sqrt(2.0), gen, device)
    if "mica" in teachers:
        with torch.device("meta"):
            mica = Mica()
        out["mica"] = _fill(mica, 0.5, gen, device)
    return out
