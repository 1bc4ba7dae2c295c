"""SMIRK system: encoders + FLAME + renderer (port of
smirk_tpu/train/trainer.py, the inference part).

`SmirkSystem.infer` is the serving path: image batch -> FLAME parameters,
geometry and the fused render. The two training paths come with a later
slice of the port.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from smirk_tpu_torch.config import Config
from smirk_tpu_torch.device import resolve_device
from smirk_tpu_torch.flame.model import FlameModel
from smirk_tpu_torch.models.encoders import SmirkEncoder
from smirk_tpu_torch.models.mobilenetv3 import ARCHS, Stage
from smirk_tpu_torch.render.renderer import Renderer


class SmirkSystem:
    """Module bundle for inference.

    backbone_stages maps backbone names (the config's
    `arch.backbone_*`) to stage tables; names not in it are looked up in
    `mobilenetv3.ARCHS`. The encoder starts from a seeded random init
    (`init_weights`); load trained weights with
    `self.encoder.load_state_dict`.
    """

    def __init__(
        self,
        config: Config,
        bundle: Dict[str, np.ndarray],
        *,
        device: Optional[str] = None,
        raster_compact: Optional[int] = None,
        backbone_stages: Optional[Mapping[str, Sequence[Stage]]] = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        c = config
        if c.arch.bf16_compute:
            raise NotImplementedError(
                "arch.bf16_compute is not ported yet; the port runs fp32")
        tables = dict(ARCHS, **(backbone_stages or {}))
        self.flame = FlameModel(bundle, n_shape=c.arch.num_shape,
                                n_exp=c.arch.num_expression, device=self.device)
        self.renderer = Renderer(bundle, render_full_head=c.render.full_head,
                                 image_size=c.image_size,
                                 raster_compact=raster_compact,
                                 device=self.device)
        self.encoder = SmirkEncoder(
            n_exp=c.arch.num_expression,
            n_shape=c.arch.num_shape,
            pose_stages=tables[c.arch.backbone_pose],
            shape_stages=tables[c.arch.backbone_shape],
            expression_stages=tables[c.arch.backbone_expression],
        ).init_weights(torch.Generator().manual_seed(0)).to(self.device)

    @torch.inference_mode()
    def infer(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B,S,S,3) f32 NHWC images in [0,1] -> params + geometry + render.

        The renderer's 2D projected `landmarks_fan`/`landmarks_mp` replace
        FLAME's 3D ones in the result, as in the JAX package."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        enc_out = self.encoder(img)
        flame_out = self.flame(enc_out)
        rend = self.renderer(
            flame_out["vertices"], enc_out["cam"],
            {"landmarks_fan": flame_out["landmarks_fan"],
             "landmarks_mp": flame_out["landmarks_mp"]},
            inference=True,
        )
        return {**enc_out, **flame_out, **rend}
