"""Batched inference over a directory of images with the port's Predictor
(the twin of examples/predict.py).

  python -m smirk_tpu_torch.examples.predict --images <dir>
      [--checkpoint ckpt.pt] [--out out_dir] [--batch 8] [--device cpu]

Writes per-image side-by-side [input | render] panels and one params.npz
with the stacked FLAME codes. Runs without a checkpoint (random weights;
the outputs are then layout demos, not reconstructions). Without --device
it runs on the card. See `expression_edit` for the encode / edit /
re-render split and `reconstruct` for the fuse generator's path.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="predict_out")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    args = p.parse_args(argv)

    from PIL import Image

    from smirk_tpu_torch import Predictor

    pred = Predictor(checkpoint=args.checkpoint, device=args.device)
    names = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    os.makedirs(args.out, exist_ok=True)
    codes = []
    for i in range(0, len(names), args.batch):
        chunk = names[i:i + args.batch]
        imgs = np.stack([
            np.asarray(Image.open(os.path.join(args.images, n)).convert("RGB")
                       .resize((pred.image_size, pred.image_size)))
            for n in chunk])
        out = pred(imgs)
        codes.append(np.concatenate(
            [out["expression_params"], out["jaw_params"], out["pose_params"]], axis=-1))
        for j, n in enumerate(chunk):
            panel = np.concatenate(
                [imgs[j] / 255.0, np.clip(out["rendered_img"][j], 0, 1)], axis=1)
            Image.fromarray((panel * 255).astype(np.uint8)).save(
                os.path.join(args.out, f"panel_{n}"))
    np.savez(os.path.join(args.out, "params.npz"),
             codes=np.concatenate(codes), names=np.asarray(names))
    print(f"wrote {len(names)} panels + params.npz to {args.out}")


if __name__ == "__main__":
    main()
