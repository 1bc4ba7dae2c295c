"""The one load generator: a traffic file's parameters and --seed -> a
pool of distinct inputs on the device, each with every random draw the
entry point takes, made with one `torch.Generator` on the device.

Training items are smirk_tpu_torch/bench.py's `train_batch` (at commit
19e99aba3b04; made here on the device): images uniform in [0, 1), FAN
and mediapipe landmarks uniform in [-1, 1), every FAN flag set, a
per-pixel hull mask (1 = background) at 0.5, a 112 px MICA crop uniform
in [0, 1); with the draws of both training paths (the mesh sampler's u
and barycentrics, the mask's noise and drop centres, the cycle path's
augmentation draws, as SmirkSystem draws them). Serving items are images
uniform in [0, 1).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference.masking import random_barycentric

# the masks' random hint-drop rates of path 1 and of the cycle path
RANDOM_MASK, CYCLE_RANDOM_MASK = 0.01, 0.005


def train_batch(B: int, S: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device)

    return {
        "img": uni(B, S, S, 3),
        "landmarks_fan": uni(B, 68, 2) * 2 - 1,
        "flag_landmarks_fan": torch.ones((B,), dtype=torch.bool, device=device),
        "landmarks_mp": uni(B, 105, 2) * 2 - 1,
        "mask": (uni(B, S, S, 1) > 0.5).to(torch.float32),
        "img_mica": uni(B, 112, 112, 3),
    }


def augment_draws(n: int, D: int, n_templates: int, n_eyelid: int, gen, device):
    """The cycle path's augmentation draws for n rows of D expression
    components (smirk_tpu_torch/train/trainer.py's augment_draws)."""
    q = n // 4
    r = n - 3 * q

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "perm": torch.randperm(n, generator=gen, device=device),
        "pm": torch.bernoulli(torch.full((q, D), 0.5, device=device), generator=gen),
        "noise0": nrm(q, D), "scale0": uni(q, 1),
        "jitter_scale0": uni(q, 1), "jitter0": nrm(q, D),
        "inner": torch.randperm(q, generator=gen, device=device),
        "scale1": uni(q, 1), "jitter_scale1": uni(q, 1), "jitter1": nrm(q, D),
        "tidx": torch.randint(0, n_templates, (q,), generator=gen, device=device),
        "scale2": uni(q, 1), "jitter_scale2": uni(q, 1), "jitter2": nrm(q, D),
        "jaw_mask": torch.bernoulli(torch.full((n, 1), 0.5, device=device), generator=gen),
        "jaw_noise": nrm(n, 3),
        "eyelid_u": uni(n, n_eyelid),
        "jitter_scale3": uni(r, 1), "jitter3": nrm(r, D),
        "eyelid3": uni(r, n_eyelid),
    }


def path_draws(rows: int, B: int, S: int, points: int, rate: float, gen, device):
    """The mesh sampler's and the mask's draws of one path: u, bary for B
    rows, noise and drop centres for `rows` (Ke x B) rows."""
    return {
        "u": torch.rand((B, points), generator=gen, device=device),
        "bary": random_barycentric((B, points), gen, device),
        "noise": torch.randn((rows, S, S, 3), generator=gen, device=device),
        "drop_centers": torch.bernoulli(torch.full((rows, S, S, 1), rate, device=device),
                                        generator=gen),
    }


def train_draws(cfg, B: int, gen, device) -> Dict[str, Dict]:
    S, t = cfg["image_size"], cfg["train"]
    points = int(t["mask_ratio"] * S * S)
    Ke = t["Ke"]
    out = {"path1": path_draws(B, B, S, points, RANDOM_MASK, gen, device)}
    if cfg["arch"]["enable_fuse_generator"] and t["loss_weights"]["cycle_loss"] > 0:
        out["path2"] = path_draws(Ke * B, B, S, points, CYCLE_RANDOM_MASK, gen, device)
        out["path2"]["augment"] = augment_draws(Ke * B, cfg["arch"]["num_expression"], 1, 2,
                                                gen, device)
    return out


def make_pool(traffic: Dict, cfg: Dict, seed: int, device) -> List[Dict]:
    """-> `traffic["pool"]` distinct items of `traffic["batch"]` rows:
    {"batch", "draws"} for the training entry, {"img"} for serving."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    B, S = traffic["batch"], cfg["image_size"]
    if traffic["entry"] == "train_step":
        return [{"batch": train_batch(B, S, gen, device), "draws": train_draws(cfg, B, gen, device)}
                for _ in range(traffic["pool"])]
    return [{"img": torch.rand((B, S, S, 3), generator=gen, device=device)}
            for _ in range(traffic["pool"])]
