"""High-level inference API (port of smirk_tpu/api.py):

    from smirk_tpu_torch import Predictor

    pred = Predictor(checkpoint="model.pt")  # or the JAX package's .npz export
    out = pred(images)                       # (B,H,W,3) uint8 or float
    out["expression_params"], out["vertices"], out["rendered_img"], ...
    out = pred(frames, landmarks=lmk)        # scale-1.4 landmark crop

    pred = Predictor(checkpoint="model.pt", use_generator=True)
    rec = pred.reconstruct(frames, lmk)      # + cropped/masked/reconstructed

Images are resized (or, with `landmarks=`, cropped around the landmarks)
to the model resolution on the device, then encode -> FLAME -> render runs
on the card (device="cpu" runs the plain versions). `reconstruct` adds the
hull mask of the landmarks, the mesh-anchored pixel hints and the fuse
generator (`SmirkSystem.reconstruct`). Results come back as numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import math

import numpy as np
import torch

from smirk_tpu_torch import assets
from smirk_tpu_torch.config import Config
from smirk_tpu_torch.data import transforms as T
from smirk_tpu_torch.device import fp32_math
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils.checkpoint import load_model, read_model

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


def _pil_resize(q: torch.Tensor, size) -> torch.Tensor:
    """(B,H,W,C) uint8 -> (B,h,w,C) uint8 for size = h = w or (h, w), the
    result of Pillow's `Image.resize((w, h))` (bicubic) on each image: a
    horizontal, then a vertical pass, each rounding to uint8 in Pillow's
    fixed point. The sums are integers below 2^53, so float64 holds them
    exactly."""
    B, H, W, _ = q.shape
    oh, ow = (size, size) if isinstance(size, int) else size

    def rounded(acc):  # (acc + 2^21) >> 22, clipped to [0, 255]
        return torch.floor((acc + (1 << (_PIL_BITS - 1))) / (1 << _PIL_BITS)).clamp(0, 255)

    kw = torch.as_tensor(_pil_weights(W, ow), device=q.device) if W != ow else None
    kh = torch.as_tensor(_pil_weights(H, oh), device=q.device) if H != oh else None
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


# the port's one model reader (a reference-layout .pt / .tar or flat .npz,
# or the JAX package's .npz model export); kept under this name for callers
load_checkpoint = read_model


def load_weights(system: SmirkSystem, checkpoint: Optional[str],
                 use_generator: bool) -> None:
    """Load a model file's encoder and, with use_generator, its generator
    (when the file and the system have one) into the system's modules
    (`utils.checkpoint.load_model`)."""
    if checkpoint:
        load_model(system, checkpoint, generator=use_generator)


class Predictor:
    """Batched single-call inference over the SMIRK pipeline.

    Args:
      checkpoint: a model file (`utils.checkpoint.read_model`: a
        reference-layout .pt / .tar or flat .npz, or the JAX package's .npz
        model export); None = random init (layout/shape-compatible, for
        smoke tests).
      use_generator: also load the fuse generator's weights (needed only
        for `reconstruct`).
      device: None = the CUDA card (raises without one); "cpu" runs the
        plain PyTorch versions.
      bundle: FLAME asset bundle; None = `assets.load_all()`.
      config, raster_compact, backbone_stages: passed to `SmirkSystem`.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 use_generator: bool = False,
                 device: Optional[str] = None,
                 bundle: Optional[dict] = None,
                 config: Optional[Config] = None,
                 raster_compact: Optional[int] = None,
                 backbone_stages=None):
        self.system = SmirkSystem(
            config or Config(), bundle if bundle is not None else assets.load_all(),
            device=device, raster_compact=raster_compact,
            backbone_stages=backbone_stages, training=False)
        self.use_generator = use_generator and self.system.generator is not None
        load_weights(self.system, checkpoint, self.use_generator)
        self.image_size = self.system.config.image_size
        self.device = self.system.device

    def _images(self, images) -> torch.Tensor:
        """uint8/float images (B,H,W,3) or (H,W,3) -> (B,H,W,3) f32 in [0,1]
        on the device (uint8 crosses to the device as uint8)."""
        images = np.asarray(images)
        was_integer = np.issubdtype(images.dtype, np.integer)
        if images.ndim == 3:
            images = images[None]
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        elif not images.flags.writeable:  # torch wraps only writeable arrays
            images = images.copy()
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = x.to(torch.float32)
        # dtype decides the 0-255 branch; the max() check remains only for
        # float arrays holding 0-255 data
        if was_integer or float(x.max()) > 2.0:
            x = T.div_exact(x, 255.0)
        return x

    def _crop(self, images, landmarks) -> Tuple[torch.Tensor, np.ndarray]:
        """-> ((B,S,S,3) f32 in [0,1] on the device, (B,K,2) float32
        landmarks in the crop's pixels): the scale-1.4 landmark-bbox crop,
        clip(warp(img * 255), 0, 255) / 255 as the JAX package computes it.
        One (K,2+) landmark set serves every image."""
        x = self._images(images)
        landmarks = np.asarray(landmarks)
        if landmarks.ndim == 2:  # one landmark set for every image
            landmarks = np.broadcast_to(landmarks, (x.shape[0],) + landmarks.shape)
        elif landmarks.shape[0] != x.shape[0]:
            raise ValueError(f"landmarks batch {landmarks.shape[0]} != images "
                             f"batch {x.shape[0]}")
        crop, _, kpts = T.crop_faces(x * 255.0, landmarks, self.image_size)
        return crop, kpts

    def _prepare(self, images, landmarks) -> torch.Tensor:
        """uint8/float images (B,H,W,3) or (H,W,3) -> (B,S,S,3) f32 in
        [0,1] on the device: landmark-cropped (`_crop`) when landmarks are
        given, else other sizes go through uint8 and the JAX package's
        resize (Pillow's bicubic), reproduced exactly."""
        if landmarks is not None:
            return self._crop(images, landmarks)[0]
        x = self._images(images)
        S = self.image_size
        if x.shape[1:3] != (S, S):
            q = _pil_resize((x.clamp(0, 1) * 255).to(torch.uint8), S)
            # uint8 / 255 in float64, then float32, as numpy does it
            x = T.div_exact(q.to(torch.float64), 255.0).to(torch.float32)
        return x.contiguous()

    @staticmethod
    def _to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def __call__(self, images, landmarks=None) -> Dict[str, np.ndarray]:
        """Full pipeline: FLAME params + geometry + rendered images."""
        return self._to_numpy(self.system.infer(self._prepare(images, landmarks)))

    @fp32_math()
    @torch.inference_mode()
    def encode(self, images, landmarks=None) -> Dict[str, np.ndarray]:
        """Encoder only: FLAME parameters without geometry or rendering."""
        return self._to_numpy(self.system.encoder(self._prepare(images, landmarks),
                                                  self.system.compute_dtype))

    def reconstruct(self, images, landmarks, seed: int = 0,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, np.ndarray]:
        """Analysis-by-neural-synthesis reconstruction, batched: crop around
        the landmarks, render the predicted mesh, hull-mask the crop, add
        the mesh-anchored pixel hints with the randomized point budget and
        run the fuse generator on [render | masked crop]
        (`SmirkSystem.reconstruct`).

        Needs Predictor(use_generator=True) and mediapipe-style landmarks
        (K >= 3, 2+) per image (or one set for all) in input-image
        coordinates: they drive the crop and the hull mask. The draws come
        from a torch.Generator seeded with `seed`; `draws` hands over
        tensors instead (see `SmirkSystem.masked_input`). Returns the
        __call__ outputs plus `cropped_img`, `masked_img` and
        `reconstructed_img`.
        """
        if not self.use_generator:
            raise ValueError("reconstruct() needs the fuse generator: build the "
                             "Predictor with use_generator=True")
        if landmarks is None:
            raise ValueError("reconstruct() needs landmarks for the crop and the "
                             "hull mask")
        imgs, kpts = self._crop(images, landmarks)
        S = self.image_size
        hull = T.convex_hull_mask(kpts, (S, S), self.device)[..., None]  # 1 = background
        out = self.system.infer(imgs)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        masked, recon = self.system.reconstruct(out, imgs, hull, gen, draws)
        return self._to_numpy({"cropped_img": imgs, **out, "masked_img": masked,
                               "reconstructed_img": recon})

    @fp32_math()
    @torch.inference_mode()
    def render_params(self, params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """FLAME params (from __call__/encode, possibly edited) -> fresh
        geometry + render."""
        p = {k: torch.as_tensor(np.asarray(v), device=self.device)
             for k, v in params.items()}
        flame_out = self.system.flame(p)
        rend = self.system.renderer(flame_out["vertices"], p["cam"], inference=True)
        return self._to_numpy({**flame_out, **rend})
