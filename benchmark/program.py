"""The system under test, built from a configuration file and the seeded
weights: `smirk_tpu_torch`'s SmirkSystem, its teachers the program's own
modules with the benchmark's weights loaded."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch


def config(cfg: Mapping):
    """The configuration file's recipe -> the program's Config."""
    from smirk_tpu_torch.config import (ArchConfig, Config, LossWeights, RenderConfig,
                                        TrainConfig)

    train = dict(cfg["train"])
    train["loss_weights"] = LossWeights(**train["loss_weights"])
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(train) - fields
    if unknown:
        raise KeyError(f"unknown train keys {sorted(unknown)}")
    return Config(image_size=cfg["image_size"], train=TrainConfig(**train),
                  arch=ArchConfig(**cfg["arch"]), render=RenderConfig(**cfg["render"]))


def steps_per_epoch(cfg: Mapping) -> int:
    return cfg["train"]["samples_per_epoch"] // cfg["train"]["batch_size"]


def system(cfg: Mapping, bundle: Dict, weights: Mapping, device, training: bool = True):
    """SmirkSystem with the seeded weights loaded into every module."""
    from smirk_tpu_torch.models.mica import Mica
    from smirk_tpu_torch.models.vgg import VGG16Features
    from smirk_tpu_torch.train.trainer import SmirkSystem

    def teacher(cls, key):
        if key not in weights:
            return None
        with torch.device(device):  # built on the card, not initialized on the host
            module = cls()
        module.load_state_dict(weights[key])
        return module

    kw = {}
    if cfg["arch"]["enable_fuse_generator"]:
        kw = {"generator_features": cfg["generator_features"],
              "generator_res_blocks": cfg["generator_res_blocks"]}
    sys_ = SmirkSystem(config(cfg), bundle, device=str(device),
                       steps_per_epoch=steps_per_epoch(cfg),
                       vgg_variables=teacher(VGG16Features, "vgg"),
                       mica_variables=teacher(Mica, "mica"), training=training, **kw)
    sys_.encoder.load_state_dict(weights["encoder"])
    if sys_.base_encoder is not None:
        sys_.base_encoder.load_state_dict(weights["encoder"])
    if sys_.generator is not None:
        sys_.generator.load_state_dict(weights["generator"])
    return sys_
