"""Checkpoint-parity harness: the port against reference outputs (the twin
of tools/check_parity.py).

  python -m smirk_tpu_torch.cli.check_parity [--checkpoint SMIRK_em1.pt]
      [--image face.png] [--ref_fixture ref.npz] [--device cpu]

The parity gate of BASELINE.json: vertex RMSE < 1e-3, with the FLAME
parameters and the projected landmarks alike, against the reference
pipeline on a released checkpoint. This harness

1. loads the reference-layout checkpoint (`weights.load_raw_state_dict`;
   a joint SMIRK checkpoint's `smirk_encoder.*` keys) into the port's
   encoder at the default Config;
2. runs the port's encoder -> FLAME (`SmirkSystem.infer`) on the image
   (--image, else the fixture's stored input, else a seeded random one);
3. reports the parameter, vertex and landmark RMSEs against --ref_fixture
   (an npz of the reference's outputs: img, expression_params,
   pose_params, cam, shape_params, vertices and landmarks_mp, 3-D as the
   reference emits them or already projected), and exits 1 past the gate.

Where the checkpoint, the FLAME model or the fixture is absent it says so
and reports what it can, as the JAX tool does: with random weights only
the plumbing is checked, and with the synthetic FLAME stand-in vertex
parity is not meaningful. Without --device it runs on the card.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GATE = 1e-3  # BASELINE.json's vertex RMSE, applied to every reported RMSE


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB").resize((224, 224)),
                      np.float32)[None] / 255.0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="pretrained_models/SMIRK_em1.pt")
    p.add_argument("--image", default=None,
                   help="224x224 face crop (png); random input if omitted")
    p.add_argument("--ref_fixture", default=None,
                   help="npz of reference outputs (img, params..., vertices)")
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    args = p.parse_args(argv)

    import torch

    from smirk_tpu_torch import assets
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.render import camera
    from smirk_tpu_torch.train.trainer import SmirkSystem
    from smirk_tpu_torch.utils import weights

    bundle = assets.load_all()
    if bundle.get("is_synthetic_flame", True):
        print("[warn] FLAME2020 pkl missing -> synthetic deformation tensors; vertex "
              "parity vs the reference is NOT meaningful until the licensed model is "
              "installed (quick_install.sh).")

    ref = None
    if args.ref_fixture and os.path.isfile(args.ref_fixture):
        ref = dict(np.load(args.ref_fixture))
    elif args.ref_fixture:
        print(f"[warn] {args.ref_fixture} not found")

    if args.image:
        img = _load_image(args.image)
    elif ref is not None and "img" in ref:
        img = np.asarray(ref["img"], np.float32)
        img = img[None] if img.ndim == 3 else img
        print("[ok] using the fixture's stored input image")
    else:
        img = np.random.default_rng(0).random((1, 224, 224, 3), np.float32)

    system = SmirkSystem(Config(), bundle, device=args.device, steps_per_epoch=1,
                         training=False)
    if os.path.isfile(args.checkpoint):
        sd = weights.load_raw_state_dict(args.checkpoint)
        enc = {k[len("smirk_encoder."):]: v for k, v in sd.items()
               if k.startswith("smirk_encoder.")}
        system.encoder.load_state_dict(enc or sd)
        print(f"[ok] loaded {args.checkpoint}")
    else:
        print(f"[warn] {args.checkpoint} not found -> random weights; this run only "
              "validates pipeline plumbing, not checkpoint parity.")

    ours = {k: v.cpu().numpy() for k, v in system.infer(torch.from_numpy(img)).items()}
    if ref is None:
        print("[info] reference outputs unavailable (--ref_fixture); printing the "
              "port's outputs only:")
        for k in ("pose_params", "cam", "expression_params", "jaw_params"):
            print(f"  {k}: {ours[k].ravel()[:6]}")
        return 0

    def rmse(a, b):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))

    # the reference emits raw 3-D FLAME landmarks; infer's are projected to
    # 2-D NDC by the renderer: project the reference's the same way
    ref_lmk = np.asarray(ref["landmarks_mp"], np.float32)
    if ref_lmk.shape[-1] == 3:
        ref_lmk = camera.project_landmarks(
            torch.from_numpy(ref_lmk), torch.as_tensor(ref["cam"], dtype=torch.float32)).numpy()
    report = {
        "expression_rmse": rmse(ours["expression_params"], ref["expression_params"]),
        "pose_rmse": rmse(ours["pose_params"], ref["pose_params"]),
        "cam_rmse": rmse(ours["cam"], ref["cam"]),
        "shape_rmse": rmse(ours["shape_params"], ref["shape_params"]),
        "vertex_rmse": rmse(ours["vertices"], ref["vertices"]),
        "landmarks_mp_rmse": rmse(ours["landmarks_mp"], ref_lmk),
    }
    ok = all(v < GATE for v in report.values())
    for k, v in report.items():
        print(f"  {k}: {v:.2e} {'OK' if v < GATE else 'FAIL'}")
    print("PARITY", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
