"""Minimal client for the HTTP serving daemon (smirk_tpu_torch.cli.serve;
the twin of examples/serve_client.py).

  # one-time: export an artifact and start the daemon
  python -m smirk_tpu_torch.cli.export_serving --out artifacts/smirk_b8 --batch 8
  python -m smirk_tpu_torch.cli.serve artifacts/smirk_b8 --port 8000

  # then:
  python -m smirk_tpu_torch.cli.serve_client --image face.png \\
      [--url http://localhost:8000]

Protocol (smirk_tpu_torch.serving): POST /predict with an npz body holding
key "img" (N,H,W,3) float32 in [0,1]; the response is an npz of outputs.
Against a reconstruct artifact (export_serving --reconstruct) also pass
--landmarks: the client applies the same scale-1.4 landmark face crop as
Predictor.reconstruct and the demos (in numpy, `warp_affine_np`), computes
the hull background mask in the cropped frame (`convex_hull_mask_np`), and
adds "hull" (+ "seed") to the request. The crop and hull helpers come
from smirk_tpu_torch.data.transforms; the client also needs PIL.
"""
import argparse
import io
import json
import urllib.request

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--landmarks", default=None,
                   help="npy mediapipe landmarks (478,2+) in image coords; "
                        "required when the artifact is a reconstruct export")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from PIL import Image

    meta = json.loads(urllib.request.urlopen(args.url + "/meta").read())
    _, H, W, _ = meta["input"]["shape"]

    im = Image.open(args.image).convert("RGB")

    if meta.get("kind") == "reconstruct":
        if not args.landmarks:
            raise SystemExit("this artifact needs --landmarks for the hull")
        from smirk_tpu_torch.data import transforms as T

        kpt = np.load(args.landmarks)[..., :2].astype(np.float32)
        # the scale-1.4 landmark face crop of Predictor.reconstruct and the
        # demos: a plain resize would serve worse reconstructions than the
        # in-process paths give for the same photo
        tform = T.crop_face_tform(kpt, scale=1.4, image_size=H)
        img = np.clip(
            T.warp_affine_np(np.asarray(im, np.float32), tform, (H, W)), 0, 255
        ) / 255.0
        kpt_c = T.transform_points(tform, kpt)
        payload = {
            "img": img[None].astype(np.float32),
            "hull": T.convex_hull_mask_np(kpt_c, (H, W))[None, :, :, None],
            "seed": np.int64(args.seed),
        }
    else:
        img = np.asarray(im.resize((W, H)), np.float32) / 255.0
        payload = {"img": img[None]}

    buf = io.BytesIO()
    np.savez(buf, **payload)
    req = urllib.request.Request(
        args.url + "/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
    for k in out.files:
        print(f"{k}: shape {out[k].shape}")
    return {k: out[k] for k in out.files}


if __name__ == "__main__":
    main()
