"""Frozen dataclass configuration with YAML + dotted CLI overlays.

A copy of `smirk_tpu/config.py` (plain dataclasses, no framework import), so
the PyTorch port and the JAX package read the same YAML recipes without the
port importing the JAX package. Keep the two schemas in step.

Replaces the reference's OmegaConf usage (train.py:10-18). The config is
immutable; the reference mutates `config.train.freeze_*` per batch
(base_trainer.py:258-268), here the freeze schedule is a function of the
step counter.

YAML files with the reference's schema (configs/config_train.yaml /
config_pretrain.yaml) load directly; unknown keys raise (struct mode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class LossWeights:
    landmark_loss: float = 100.0
    perceptual_vgg_loss: float = 10.0
    reconstruction_loss: float = 10.0
    emotion_loss: float = 0.0
    jaw_regularization: float = 1e-2
    expression_regularization: float = 1e-3
    shape_regularization: float = 100.0
    cycle_loss: float = 1.0
    mica_loss: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    num_epochs: int = 50
    batch_size: int = 32
    num_workers: int = 8
    log_path: str = "logs/1"
    log_losses_every: int = 10
    visualize_every: int = 50
    mask_ratio: float = 0.01
    mask_ratio_mul: float = 5.0
    mask_dilation_radius: int = 10
    save_every: int = 2
    # full-TrainState checkpoint every N train steps (0 = epoch-end only).
    # Bounds lost work under worker crashes; restart-based recovery
    # (SURVEY §5) via tools/train_supervisor.py + resume_state.
    ckpt_every_steps: int = 0
    # "split" (default) = path 1 and the cycle path as two jitted
    # programs; "fused" = one program. Identical math (exact-equality
    # tested); split measured 268.1/210.0 ms vs fused 271.0/213.3 at
    # batch 64 bf16 AND avoids the fused parity-1 fp32 worker crash
    # (PARITY.md). SMIRK_STEP_MODE env overrides.
    step_mode: str = "split"
    # jax.checkpoint (rematerialization) over the cycle path's generator
    # and re-encode applies: recompute their forwards during backward
    # instead of keeping activations. MEASURED NEGATIVE on v5e (the cycle
    # is FLOP-bound: parity 0 +83%, tools/tpu_cycle_attack.py, PARITY.md)
    # — keep off unless a future shape is activation-memory-bound.
    remat_cycle: bool = False
    use_wandb: bool = False
    Ke: int = 1
    samples_per_epoch: int = 50000
    use_base_model_for_regularization: bool = False
    resume_epoch: int = 0
    train_scale_min: float = 1.2
    train_scale_max: float = 1.8
    test_scale: float = 1.6
    loss_weights: LossWeights = field(default_factory=LossWeights)
    optimize_pose: bool = False
    optimize_shape: bool = False
    optimize_expression: bool = True
    # declared for schema parity; the live schedule is step-parity driven
    freeze_encoder_in_second_path: bool = False
    freeze_generator_in_second_path: bool = False


@dataclass(frozen=True)
class ArchConfig:
    backbone_pose: str = "tf_mobilenetv3_small_minimal_100"
    backbone_shape: str = "tf_mobilenetv3_large_minimal_100"
    backbone_expression: str = "tf_mobilenetv3_large_minimal_100"
    num_expression: int = 50
    num_shape: int = 300
    use_eyelids: bool = True
    enable_fuse_generator: bool = True
    # bf16 conv/BN compute in the encoder backbones + generator (params,
    # BN stats, heads and losses stay f32). Off by default: fp32 matches the
    # reference numerics; flip for throughput on TPU.
    bf16_compute: bool = False
    # bf16 compute for the FROZEN module applications in the cycle path
    # only (the parity-0 frozen-encoder re-forward whose backward flows to
    # the generator, and the parity-1 stop-gradiented generator forward).
    # A targeted subset of bf16_compute for fp32 training runs: the frozen
    # outputs feed only the cycle MSE / the re-encode input. No-op when
    # bf16_compute is already on. MEASURED NEUTRAL on v5e (parity 0 270.7
    # vs 270.4 ms fp32 base — the fp32 backward into the UNet dominates;
    # tools/tpu_cycle_attack.py, PARITY.md cycle-path table).
    bf16_cycle_frozen: bool = False
    # ImageNet-pretrained backbone init (reference smirk_encoder.py:7-12
    # passes pretrained=True to timm): paths to raw timm tf_mobilenetv3
    # state dicts (.pt/.tar via torch, .npz via numpy); empty = random init
    # (documented deviation when the files are absent, see PARITY.md)
    backbone_init_small: str = ""
    backbone_init_large: str = ""


@dataclass(frozen=True)
class RenderConfig:
    full_head: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    LRS3_path: str = ""
    LRS3_landmarks_path: str = ""
    MEAD_path: str = ""
    MEAD_fan_landmarks_path: str = ""
    MEAD_mediapipe_landmarks_path: str = ""
    FFHQ_path: str = ""
    FFHQ_fan_landmarks_path: str = ""
    FFHQ_mediapipe_landmarks_path: str = ""
    CelebA_path: str = ""
    CelebA_fan_landmarks_path: str = ""
    CelebA_mediapipe_landmarks_path: str = ""
    BUPT_path: str = ""
    BUPT_fan_landmarks_path: str = ""
    BUPT_mediapipe_landmarks_path: str = ""
    MEAD_sides_path: str = ""
    LRS3_percentage: float = 0.2
    LRS3_temporal_sampling: bool = False
    MEAD_percentage: float = 0.1
    FFHQ_percentage: float = 0.3
    CelebA_percentage: float = 0.3
    MEAD_sides_percentage: float = 0.1
    sample_full_video_for_testing: bool = False


@dataclass(frozen=True)
class Config:
    resume: str = ""
    # full-TrainState resume (params + BN stats + optimizer moments + step),
    # written by train.ckpt_every_steps / epoch-end last_state.npz. Exact
    # continuation; intra-epoch progress past the checkpoint replays.
    resume_state: str = ""
    load_encoder: bool = True
    load_fuse_generator: bool = True
    device: str = ""  # schema field; the port takes device= arguments
    image_size: int = 224
    K: int = 1
    deterministic: bool = False
    train: TrainConfig = field(default_factory=TrainConfig)
    arch: ArchConfig = field(default_factory=ArchConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)


def _build(cls, data: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key: {k} (for {cls.__name__})")
        if v is None:
            # a null YAML value at any depth means "unset, use the default"
            # (the reference's OmegaConf configs use `resume:` this way);
            # passing None into a typed frozen field would surface as an
            # AttributeError far from the config load
            continue
        ftype = fields[k].type
        sub = _DATACLASS_BY_NAME.get(str(ftype).split(".")[-1].strip("'>"), None)
        if isinstance(v, dict):
            target = sub or _infer_dc(fields[k])
            kwargs[k] = _build(target, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _infer_dc(f):
    t = f.default_factory() if f.default_factory is not dataclasses.MISSING else None
    return type(t)


_DATACLASS_BY_NAME = {
    c.__name__: c
    for c in (LossWeights, TrainConfig, ArchConfig, RenderConfig, DatasetConfig)
}


def load_config(path: Optional[str] = None, overrides: Tuple[str, ...] = ()) -> Config:
    """Load YAML (optional) and apply dotted overrides like 'train.lr=1e-4'."""
    data: Dict[str, Any] = {}
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _build(Config, data)
    for ov in overrides:
        cfg = apply_override(cfg, ov)
    return cfg


def apply_override(cfg: Config, dotted: str) -> Config:
    """'a.b.c=value' -> new Config with the field replaced (type-coerced)."""
    keypath, _, raw = dotted.partition("=")
    keys = keypath.strip().split(".")

    def rec(obj, keys):
        k, rest = keys[0], keys[1:]
        cur = getattr(obj, k)
        if rest:
            return dataclasses.replace(obj, **{k: rec(cur, rest)})
        return dataclasses.replace(obj, **{k: _coerce(raw, cur)})

    return rec(cfg, keys)


def _coerce(raw: str, current: Any):
    raw = raw.strip()
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    return raw
