"""Expression editing: encode once, edit the FLAME codes, re-render (the
twin of examples/expression_edit.py).

  python -m smirk_tpu_torch.examples.expression_edit --image face.png
      [--checkpoint ckpt.pt] [--amplify 2.0] [--jaw_open 0.2]
      [--out edit.png] [--device cpu]

The encoder runs once (`Predictor.encode`); each edit re-renders without
re-encoding (`Predictor.render_params`). Writes [input | reconstruction |
edited]. Without --device it runs on the card.
"""
import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--amplify", type=float, default=2.0,
                   help="expression amplification factor")
    p.add_argument("--jaw_open", type=float, default=0.0,
                   help="added jaw-opening (radians, ~0.0-0.3)")
    p.add_argument("--out", default="edit.png")
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    args = p.parse_args(argv)

    from PIL import Image

    from smirk_tpu_torch import Predictor

    pred = Predictor(checkpoint=args.checkpoint, device=args.device)
    img = np.asarray(Image.open(args.image).convert("RGB"))

    params = pred.encode(img)
    base = pred.render_params(params)

    edited = dict(params)
    edited["expression_params"] = params["expression_params"] * args.amplify
    if args.jaw_open:
        jaw = params["jaw_params"].copy()
        jaw[:, 0] += args.jaw_open
        edited["jaw_params"] = jaw
    moved = pred.render_params(edited)

    S = pred.image_size
    inp = np.asarray(Image.fromarray(img).resize((S, S))) / 255.0
    panel = np.concatenate(
        [inp, np.clip(base["rendered_img"][0], 0, 1),
         np.clip(moved["rendered_img"][0], 0, 1)], axis=1)
    Image.fromarray((panel * 255).astype(np.uint8)).save(args.out)
    print(f"wrote {args.out}  [input | reconstruction | edited]")


if __name__ == "__main__":
    main()
