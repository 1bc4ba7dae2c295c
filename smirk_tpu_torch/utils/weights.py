"""Weight layout conversion from the JAX package's variables.

`encoder_state_dict_from_jax` and `generator_state_dict_from_jax` turn the
Flax `SmirkEncoder` / `SmirkGenerator` variables of the JAX package (a
nested dict of arrays with `params` and `batch_stats`) into this port's
state dicts, without importing JAX. The rules invert
`smirk_tpu/utils/importer.py`:

  conv kernel  HWIO -> OIHW (depthwise (3,3,1,C) -> (C,1,3,3), same transpose)
  ConvTranspose kernel (kh,kw,I,O) -> (I,O,kh,kw), spatially flipped
  Dense kernel (I,O) -> Linear weight (O,I)
  BN scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var
  module names: trailing `_<digits>` become list indices
  (blocks_0_1 -> blocks.0.1, pose_cam_layers_0 -> pose_cam_layers.0);
  generator blocks take the reference's names (encoder1/conv1 ->
  encoder1.enc1conv1, resnet_blocks_0/norm2 -> resnet_blocks.0.conv_block.6)

`load_raw_state_dict` and `init_backbones_from_state_dicts` (the JAX
package's `utils/importer.py` counterparts) start the three encoders'
feature extractors from raw timm `tf_mobilenetv3_*` state dicts.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

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


# generator block shorthands of the reference (smirk_generator.py)
_GEN_SHORT = {
    "encoder1": "enc1", "encoder2": "enc2", "encoder3": "enc3",
    "encoder4": "enc4", "decoder1": "dec1", "decoder2": "dec2",
    "decoder3": "dec3", "decoder4": "dec4", "bottleneck": "bottleneck",
}
# ResnetBlock conv_block indices (pad, conv, norm, relu, pad, conv, norm)
_RES_IDX = {"conv1": 1, "norm1": 2, "conv2": 5, "norm2": 6}
_RES_BLOCK = re.compile(r"resnet_blocks_(\d+)")


def _torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if len(mods) > 1 and mods[0] in _GEN_SHORT:
        return f"{mods[0]}.{_GEN_SHORT[mods[0]]}{mods[1]}.{_LEAF_TO_TORCH[leaf]}"
    m = _RES_BLOCK.fullmatch(mods[0]) if mods else None
    if m:
        return (f"resnet_blocks.{m.group(1)}.conv_block."
                f"{_RES_IDX[mods[1]]}.{_LEAF_TO_TORCH[leaf]}")
    return ".".join([_TRAILING_IDX.sub(r".\1", m) for m in mods]
                    + [_LEAF_TO_TORCH[leaf]])


def _state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[collection]):
            arr = np.array(leaf, np.float32)  # a writable copy
            if path[-1] == "kernel" and arr.ndim == 4 and path[-2].startswith("upconv"):
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif path[-1] == "kernel" and arr.ndim == 4:
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


def encoder_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} -> state dict for `SmirkEncoder`
    (with the `num_batches_tracked` buffers torch batch norm carries)."""
    return _state_dict_from_jax(variables)


def generator_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the Flax `SmirkGenerator` ->
    state dict for the port's `SmirkGenerator` (reference key names)."""
    return _state_dict_from_jax(variables)


def load_raw_state_dict(path: str) -> Dict[str, Any]:
    """A torch .pt/.tar pickle (loaded on the CPU) or an .npz -> a flat
    tensor dict; unwraps the common {'state_dict': ...} nesting."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def init_backbones_from_state_dicts(encoder: torch.nn.Module,
                                    small_sd: Optional[Mapping[str, Any]] = None,
                                    large_sd: Optional[Mapping[str, Any]] = None) -> None:
    """ImageNet-pretrained backbone init of a `SmirkEncoder`, in place: raw
    timm tf_mobilenetv3 state dicts (conv_stem., bn1., blocks.i.j...) onto
    the feature extractors `{pose,shape,expression}_encoder.encoder` (the
    small dict onto the pose encoder, the large onto the other two). The
    heads keep their init; keys the backbone lacks (conv_head, classifier)
    are ignored, a backbone key the dict lacks keeps its init, and a shape
    mismatch raises ValueError."""
    targets = [("pose_encoder", small_sd), ("shape_encoder", large_sd),
               ("expression_encoder", large_sd)]
    for name, sd in targets:
        if sd is None:
            continue
        backbone = getattr(encoder, name).encoder
        own = backbone.state_dict()
        take = {}
        for k, v in own.items():
            if k not in sd:
                continue
            t = torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(sd[k]) else sd[k])
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {name}.encoder.{k}: state dict "
                                 f"{tuple(t.shape)} vs model {tuple(v.shape)}")
            take[k] = t
        backbone.load_state_dict(take, strict=False)
