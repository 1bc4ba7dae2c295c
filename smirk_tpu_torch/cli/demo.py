"""Single-image demo (the twin of smirk_tpu/cli/demo.py): one image ->
FLAME parameters, the render and, with the fuse generator, the
reconstruction, written as a side-by-side panel.

    python -m smirk_tpu_torch.cli.demo --input_path face.png \
        --landmarks lmk.npy --crop --use_smirk_generator --render_orig

Landmark detection uses mediapipe when it is importable; otherwise pass
--landmarks <npy> (478x2+ mediapipe points) or omit --crop to feed the
resized image. Runs on the CUDA card unless --device cpu.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from smirk_tpu_torch.device import resolve_device


def build_system(checkpoint: Optional[str], use_generator: bool,
                 device: Optional[str] = None):
    """The default `Config()` system with a checkpoint's encoder (and, with
    use_generator, its generator) loaded; random init without one."""
    from smirk_tpu_torch import assets
    from smirk_tpu_torch.api import load_weights
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.train.trainer import SmirkSystem

    system = SmirkSystem(Config(), assets.load_all(), device=device, steps_per_epoch=1,
                         training=False)
    load_weights(system, checkpoint, use_generator)
    return system


def get_landmarks(image: np.ndarray, landmarks_path: Optional[str]):
    if landmarks_path:
        return np.load(landmarks_path)[..., :2]
    try:
        from smirk_tpu_torch.cli.mediapipe_utils import run_mediapipe

        return run_mediapipe(image)
    except ImportError:
        return None


def process_image(system, image: np.ndarray, kpt: Optional[np.ndarray],
                  crop: bool, use_generator: bool, rng_seed: int = 0):
    """One uint8 frame -> dict with cropped_image, tform, outputs (numpy)
    and, with the generator, masked_img / reconstructed_img."""
    from smirk_tpu_torch.api import _pil_resize
    from smirk_tpu_torch.data import transforms as T

    H0, W0 = image.shape[:2]
    S = system.config.image_size
    dev = system.device
    frame = torch.from_numpy(np.array(image, np.uint8)).to(dev)[None]
    tform = None
    if crop:
        if kpt is None:
            raise ValueError("--crop needs landmarks")
        img, tforms, kpts = T.crop_faces(frame.to(torch.float32), kpt[None], S)
        tform, kpt_c = tforms[0], kpts[0]
    else:
        img = T.div_exact(_pil_resize(frame, S).to(torch.float32), 255.0)
        kpt_c = kpt[..., :2] * [S / W0, S / H0] if kpt is not None else None

    out = system.infer(img)
    result = {"cropped_image": img[0].cpu().numpy(), "tform": tform,
              "outputs": {k: v.cpu().numpy() for k, v in out.items()}}

    if use_generator and system.generator is not None:
        if kpt_c is None:
            raise ValueError("the generator path needs landmarks")
        # the randomized point budget, hull mask and generator:
        # SmirkSystem.reconstruct, as the batched Predictor.reconstruct
        hull = T.convex_hull_mask([kpt_c], (S, S), dev)[..., None]  # 1 = background
        masked, recon = system.reconstruct(
            out, img, hull, torch.Generator(device=dev).manual_seed(rng_seed))
        result["masked_img"] = masked[0].cpu().numpy()
        result["reconstructed_img"] = recon[0].cpu().numpy()
    return result


def _to_original(img: np.ndarray, result, H0: int, W0: int, device) -> np.ndarray:
    """A (S,S,3) panel in [0,1] mapped back to the input frame: the crop's
    inverse warp, or the resize back through uint8."""
    from smirk_tpu_torch.api import _pil_resize
    from smirk_tpu_torch.data import transforms as T

    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(resolve_device(device))[None]
    if result["tform"] is not None:
        r = T.warp_affine(x, np.linalg.inv(result["tform"])[None], (H0, W0))
    else:
        r = _pil_resize((x * 255).to(torch.uint8), (H0, W0)) / 255.0
    return np.clip(r[0].cpu().numpy(), 0, 1)


def panel(image, result, render_orig: bool, device=None):
    """Build the side-by-side output panel: [input | render (|
    reconstruction)] in the crop's frame, or with render_orig in the input
    frame (the crop's inverse warp on `device`; None: the CUDA card,
    raising without one)."""
    rendered = np.asarray(result["outputs"]["rendered_img"][0])
    if render_orig:
        H0, W0 = image.shape[:2]
        cols = [image.astype(np.float32) / 255.0,
                _to_original(rendered, result, H0, W0, device)]
        if "reconstructed_img" in result:
            cols.append(_to_original(result["reconstructed_img"], result, H0, W0, device))
    else:
        cols = [result["cropped_image"], rendered]
        if "reconstructed_img" in result:
            cols.append(result["reconstructed_img"])
    return np.concatenate(cols, axis=1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--landmarks", default=None,
                   help="npy with mediapipe landmarks (478,2+)")
    p.add_argument("--crop", action="store_true")
    p.add_argument("--out_path", default="output")
    p.add_argument("--use_smirk_generator", action="store_true")
    p.add_argument("--render_orig", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' runs the "
                        "plain versions)")
    args = p.parse_args(argv)

    from PIL import Image

    from smirk_tpu_torch.utils.viz import save_image

    image = np.asarray(Image.open(args.input_path).convert("RGB"))
    system = build_system(args.checkpoint, args.use_smirk_generator, args.device)
    kpt = get_landmarks(image, args.landmarks)
    result = process_image(system, image, kpt, args.crop, args.use_smirk_generator)
    grid = panel(image, result, args.render_orig, system.device)
    os.makedirs(args.out_path, exist_ok=True)
    out = os.path.join(args.out_path, os.path.basename(args.input_path))
    save_image(grid, out)
    print("wrote", out)


if __name__ == "__main__":
    main()
