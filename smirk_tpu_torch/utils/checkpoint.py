"""Checkpoints: the full training state for an exact resume, and the model
export (port of smirk_tpu/utils/checkpoint.py).

  * `save_state` / `restore_state`: the encoder, generator and base-encoder
    state dicts, both Adam states (`enc_opt`, `gen_opt`; either may be
    None) and `system.step`, in one `torch.save` file written to
    `path + ".tmp"` and renamed over `path`, so a crash mid-save never
    leaves a torn file where the previous checkpoint was. Restoring checks
    every entry against the system first: a missing one raises KeyError, a
    shape that differs ValueError, each naming the entry.
  * `save_model` / `load_model`: the reference state-dict layout
    (`smirk_encoder.*`, `smirk_generator.*`). `read_model` is the port's one
    reader of a model file (`api.load_checkpoint` is a name for it) and
    `load_model` its one loader: `api.load_weights` (so
    `Predictor(checkpoint=)`, the demos, `cli.export_serving` and the
    examples) calls it. `read_model` reads a `.pt` /
    `.tar` torch pickle (with or without a `state_dict` entry), a flat
    reference-layout `.npz`, and the JAX package's `.npz` model export
    (`encoder/params/...`, `generator/...`) through `utils.weights`. A
    generator in the file is ignored by a system without one.

There is one format. The JAX package writes orbax directories beside its
`.npz` because of multi-host arrays; a directory path raises here. Its
full-state `.npz` is not read either: optax's Adam moments are not laid out
as torch's.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)

_MODULES = ("encoder", "generator", "base_encoder")
_OPTIMIZERS = ("enc_opt", "gen_opt")


def _no_directory(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the JAX package's orbax checkpoint layout "
            "(smirk_tpu.utils.checkpoint); the port reads and writes single "
            "torch.save files")


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_state(system, path: str) -> None:
    """The full training state of a `SmirkSystem` -> `path` (atomic)."""
    _no_directory(path)
    state: Dict[str, Any] = {"step": int(system.step)}
    for name in _MODULES:
        m = getattr(system, name)
        state[name] = None if m is None else _cpu(m.state_dict())
    for name in _OPTIMIZERS:
        opt = getattr(system, name)
        state[name] = None if opt is None else opt.state_dict()
    _atomic_save(state, path)


def _check_module(name: str, module: torch.nn.Module, saved) -> Dict[str, torch.Tensor]:
    """The saved tensors of every entry of module's state dict, checked."""
    if saved is None:
        raise KeyError(f"checkpoint missing {name}")
    out = {}
    for k, v in module.state_dict().items():
        if k not in saved:
            raise KeyError(f"checkpoint missing {name}/{k}")
        if tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {name}/{k}: ckpt "
                             f"{tuple(saved[k].shape)} vs model {tuple(v.shape)}")
        out[k] = saved[k]
    return out


def _check_optimizer(name: str, opt: torch.optim.Optimizer, saved) -> None:
    if saved is None:
        raise KeyError(f"checkpoint missing {name}")
    params = [p for g in opt.param_groups for p in g["params"]]
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    if len(ids) != len(params):
        raise ValueError(f"shape mismatch for {name}: ckpt {len(ids)} parameters vs "
                         f"optimizer {len(params)}")
    for i, p in zip(ids, params):
        for k, v in saved["state"].get(i, {}).items():
            if v.dim() and tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {name}/state/{i}/{k}: ckpt "
                                 f"{tuple(v.shape)} vs parameter {tuple(p.shape)}")


def restore_state(system, path: str) -> None:
    """Restore `save_state`'s file into `system` in place: modules,
    optimizer moments and the step. Everything is checked before anything
    is loaded."""
    _no_directory(path)
    if path.endswith(".npz"):
        raise ValueError(
            f"{path}: a JAX package full-state .npz is not read (optax's Adam "
            "moments are not laid out as torch.optim.Adam's); resume from the "
            "port's .pt, or take its weights only with load_model")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if "step" not in saved:
        raise KeyError("checkpoint missing step")
    modules = {n: _check_module(n, getattr(system, n), saved.get(n))
               for n in _MODULES if getattr(system, n) is not None}
    for n in _OPTIMIZERS:
        if getattr(system, n) is not None:
            _check_optimizer(n, getattr(system, n), saved.get(n))
    for n, sd in modules.items():
        getattr(system, n).load_state_dict(sd)
    for n in _OPTIMIZERS:
        if getattr(system, n) is not None:
            getattr(system, n).load_state_dict(saved[n])
    system.step = int(saved["step"])


def save_model(system, path: str) -> None:
    """The encoder (and the generator, when the system has one) in the
    reference state-dict layout -> `path` (atomic)."""
    _no_directory(path)
    sd = {f"smirk_encoder.{k}": v for k, v in _cpu(system.encoder.state_dict()).items()}
    if system.generator is not None:
        sd.update({f"smirk_generator.{k}": v
                   for k, v in _cpu(system.generator.state_dict()).items()})
    _atomic_save(sd, path)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def read_model(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(encoder, generator) state dicts of a model file; the generator's is
    empty when the file holds none.

      * a `.pt` / `.tar` torch pickle, its dict under `state_dict` or bare,
        or a flat `.npz` of the same keys: a joint SMIRK checkpoint holds
        `smirk_encoder.*` and `smirk_generator.*` keys; without the first
        prefix the whole dict is the encoder's;
      * the JAX package's `.npz` model export (`save_model`: keys under
        `encoder/` and `generator/`), converted by `utils.weights`; a flat
        `.npz` is taken for it only when a key starts with `encoder/`;
      * the JAX package's full-state `.npz` (keys under `.`) and a
        directory (its orbax layout) raise ValueError.
    """
    _no_directory(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        if any(k.startswith(".") for k in flat):
            raise ValueError(
                f"{path}: a JAX package full-state .npz (TrainState); its optax "
                "moments are not torch's: export the model with "
                "smirk_tpu.utils.checkpoint.save_model and load that")
        if any(k.startswith("encoder/") for k in flat):
            tree = _unflatten(flat)
            gen = tree.get("generator")
            return (encoder_state_dict_from_jax(tree["encoder"]),
                    generator_state_dict_from_jax(gen) if gen else {})
        sd = {k: torch.from_numpy(v) for k, v in flat.items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    enc = part("smirk_encoder.")
    return (enc or sd), part("smirk_generator.")


def load_model(system, path: str, generator: bool = True) -> None:
    """Load a model export into `system` in place: the encoder, and, with
    `generator`, the generator when both the file and the system have one.
    Reads `save_model`'s layout (any reference-layout state dict) and the
    JAX package's `.npz` model export (`read_model`)."""
    enc, gen = read_model(path)
    system.encoder.load_state_dict(enc)
    if generator and gen and system.generator is not None:
        system.generator.load_state_dict(gen)

