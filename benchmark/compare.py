"""The numbers that decide `correct`: each a gap between what the timed
path produced and what the reference computes from the same inputs,
weights and draws.

Training: per leaf, the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf; taken by the worst leaf for the first gradient, and per
optimizer, against that optimizer's median leaf, for the change over
the checked steps. Losses: the relative
gap of each loss of the first step. Serving: each output's largest absolute gap over
its largest reference magnitude; the render's mean absolute gap over its
mean reference magnitude.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: left out of the change
ROUNDOFF_LEAF = 1e-3


def _nan_inf(x: float) -> float:
    return float("inf") if x != x else x


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keep: Optional[Iterable[str]] = None) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf (infinite where the leaves differ)."""
    keys = list(ref if keep is None else keep)
    if set(prog) != set(ref):
        return [float("inf")]
    median = statistics.median(ref[k] for k in ref)
    return [_nan_inf(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)) for k in keys]


def group_gaps(prog: Mapping[str, float], ref: Mapping[str, float], group: Sequence[str],
               keep: Iterable[str]) -> list:
    """leaf_gaps among the leaves of one group (one optimizer's), each
    against that group's median leaf."""
    if set(prog) != set(ref):
        return [float("inf")]
    return leaf_gaps({k: prog[k] for k in group}, {k: ref[k] for k in group}, keep)


def moved_leaves(ref_grads: Mapping[str, float]) -> list:
    median = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= ROUNDOFF_LEAF * median]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(_nan_inf(abs(a - b) / max(abs(b), 1e-30)) for a, b in zip(prog, ref))


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if a.shape != b.shape:
        return float("inf")
    return _nan_inf(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))


def mean_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if a.shape != b.shape:
        return float("inf")
    return _nan_inf(float((a - b).abs().mean() / b.abs().mean().clamp_min(1e-30)))
