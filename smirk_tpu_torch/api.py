"""High-level inference API (port of smirk_tpu/api.py):

    from smirk_tpu_torch import Predictor

    pred = Predictor(checkpoint="model.pt")  # reference-layout state dict
    out = pred(images)                       # (B,H,W,3) uint8 or float
    out["expression_params"], out["vertices"], out["rendered_img"], ...

Images are resized to the model resolution, then encode -> FLAME ->
render runs on the card (device="cpu" runs the plain versions). Results
come back as numpy. Landmark cropping and `reconstruct` come with a later
slice of the port.
"""
from __future__ import annotations

from typing import Dict, Optional

import math

import numpy as np
import torch

from smirk_tpu_torch import assets
from smirk_tpu_torch.config import Config
from smirk_tpu_torch.train.trainer import SmirkSystem

__all__ = ["Predictor"]

# Pillow's 8-bit resampling keeps its weights in fixed point with 22
# fractional bits (32 - 8 - 2)
_PIL_BITS = 22
# float64 elements of one resize group; bounds the resize's memory
_RESIZE_BLOCK_ELEMS = 1 << 25


def _pil_bicubic(x: float) -> float:
    """Pillow's bicubic filter (a = -0.5), in its operation order."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _pil_weights(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's bicubic weights for one axis, in_size -> out_size, as it
    computes and rounds them for 8-bit images: (out_size, in_size) float64
    holding integers scaled by 2^22 (zero outside each output's support).
    Downscaling widens the filter by the scale (antialiasing)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_pil_bicubic((x - center + 0.5) / filterscale)
             for x in range(xmin, xmax)]
        ww = 0.0
        for v in w:  # sequential sum, as Pillow's loop
            ww += v
        for i, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            out[xx, xmin + i] = math.trunc(v * (1 << _PIL_BITS)
                                           + (0.5 if v >= 0 else -0.5))
    return out


def _pil_resize(q: torch.Tensor, size: int) -> torch.Tensor:
    """(B,H,W,C) uint8 -> (B,size,size,C) uint8, the result of Pillow's
    `Image.resize((size, size))` (bicubic) on each image: a horizontal,
    then a vertical pass, each rounding to uint8 in Pillow's fixed point.
    The sums are integers below 2^53, so float64 holds them exactly."""
    B, H, W, _ = q.shape

    def rounded(acc):  # (acc + 2^21) >> 22, clipped to [0, 255]
        return torch.floor((acc + (1 << (_PIL_BITS - 1))) / (1 << _PIL_BITS)).clamp(0, 255)

    kw = torch.as_tensor(_pil_weights(W, size), device=q.device) if W != size else None
    kh = torch.as_tensor(_pil_weights(H, size), device=q.device) if H != size else None
    group = max(1, _RESIZE_BLOCK_ELEMS // q[0].numel())
    outs = []
    for b0 in range(0, B, group):
        x = q[b0:b0 + group].to(torch.float64)
        if kw is not None:
            x = rounded(torch.einsum("bhwc,sw->bhsc", x, kw))
        if kh is not None:
            x = rounded(torch.einsum("bhwc,sh->bswc", x, kh))
        outs.append(x.to(torch.uint8))
    return torch.cat(outs)


def _load_encoder_state(path: str) -> Dict[str, torch.Tensor]:
    """Encoder weights from a reference-layout checkpoint: keys
    `smirk_encoder.*` (a joint SMIRK checkpoint) or bare encoder keys, in
    a .pt/.tar torch pickle or an .npz."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    prefix = "smirk_encoder."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


class Predictor:
    """Batched single-call inference over the SMIRK pipeline.

    Args:
      checkpoint: reference-layout state dict (see `_load_encoder_state`);
        None = random init (layout/shape-compatible, for smoke tests).
      device: None = the CUDA card (raises without one); "cpu" runs the
        plain PyTorch versions.
      bundle: FLAME asset bundle; None = `assets.load_all()`.
      config, raster_compact, backbone_stages: passed to `SmirkSystem`.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 device: Optional[str] = None,
                 bundle: Optional[dict] = None,
                 config: Optional[Config] = None,
                 raster_compact: Optional[int] = None,
                 backbone_stages=None):
        self.system = SmirkSystem(
            config or Config(), bundle if bundle is not None else assets.load_all(),
            device=device, raster_compact=raster_compact,
            backbone_stages=backbone_stages)
        if checkpoint:
            self.system.encoder.load_state_dict(_load_encoder_state(checkpoint))
        self.image_size = self.system.config.image_size
        self.device = self.system.device

    def _prepare(self, images, landmarks) -> torch.Tensor:
        """uint8/float images (B,H,W,3) or (H,W,3) -> (B,S,S,3) f32 in
        [0,1] on the device. Other sizes go through uint8 and the JAX
        package's resize (Pillow's bicubic), reproduced exactly."""
        if landmarks is not None:
            raise NotImplementedError(
                "landmark cropping is not ported yet; pass images already "
                "cropped to the face")
        images = np.asarray(images)
        was_integer = np.issubdtype(images.dtype, np.integer)
        if images.ndim == 3:
            images = images[None]
        images = images.astype(np.float32)
        if was_integer or images.max() > 2.0:  # 0-255-range input
            images = images / 255.0
        x = torch.from_numpy(images).to(self.device)
        S = self.image_size
        if x.shape[1:3] != (S, S):
            q = _pil_resize((x.clamp(0, 1) * 255).to(torch.uint8), S)
            # uint8 / 255 in float64, then float32, as numpy does it
            x = (q.to(torch.float64) / 255.0).to(torch.float32)
        return x.contiguous()

    @staticmethod
    def _to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def __call__(self, images, landmarks=None) -> Dict[str, np.ndarray]:
        """Full pipeline: FLAME params + geometry + rendered images."""
        return self._to_numpy(self.system.infer(self._prepare(images, landmarks)))

    @torch.inference_mode()
    def encode(self, images, landmarks=None) -> Dict[str, np.ndarray]:
        """Encoder only: FLAME parameters without geometry or rendering."""
        return self._to_numpy(self.system.encoder(self._prepare(images, landmarks)))

    @torch.inference_mode()
    def render_params(self, params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """FLAME params (from __call__/encode, possibly edited) -> fresh
        geometry + render."""
        p = {k: torch.as_tensor(np.asarray(v), device=self.device)
             for k, v in params.items()}
        flame_out = self.system.flame(p)
        rend = self.system.renderer(flame_out["vertices"], p["cam"], inference=True)
        return self._to_numpy({**flame_out, **rend})
