"""Weight layout conversion from the JAX package's encoder variables.

`encoder_state_dict_from_jax` turns the Flax `SmirkEncoder` variables of
the JAX package (a nested dict of arrays with `params` and `batch_stats`)
into this port's `SmirkEncoder` state dict, without importing JAX. The
rules invert `smirk_tpu/utils/importer.py`:

  conv kernel  HWIO -> OIHW (depthwise (3,3,1,C) -> (C,1,3,3), same transpose)
  Dense kernel (I,O) -> Linear weight (O,I)
  BN scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var
  module names: trailing `_<digits>` become list indices
  (blocks_0_1 -> blocks.0.1, pose_cam_layers_0 -> pose_cam_layers.0)
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight", "scale": "weight", "bias": "bias",
    "mean": "running_mean", "var": "running_var",
}
_TRAILING_IDX = re.compile(r"_(\d+)(?=_|$)")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    return ".".join([_TRAILING_IDX.sub(r".\1", m) for m in mods]
                    + [_LEAF_TO_TORCH[leaf]])


def encoder_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} -> state dict for `SmirkEncoder`
    (with the `num_batches_tracked` buffers torch batch norm carries)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[collection]):
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif path[-1] == "kernel" and arr.ndim == 2:
                arr = arr.T
            key = _torch_key(path)
            if key in out:
                raise ValueError(f"duplicate key {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if key.endswith(".running_var"):
                out[key[:-len("running_var")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.int64))
    return out
