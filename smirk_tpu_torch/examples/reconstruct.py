"""Analysis-by-neural-synthesis reconstruction with the port's Predictor
(the twin of examples/reconstruct.py).

  python -m smirk_tpu_torch.examples.reconstruct --image face.png
      --landmarks lmk.npy [--checkpoint ckpt.pt] [--seed 0]
      [--out recon.png] [--device cpu]

The predicted mesh is rendered, mesh-anchored pixel hints are sampled with
a randomized budget, the face is hull-masked out of the photo, and the
fuse generator reconstructs it from [render | masked image]
(`Predictor.reconstruct`). The panel is [input | render | masked |
reconstruction]. Landmarks: a (478, 2+) mediapipe array in input-image
coordinates. Without --device it runs on the card.
"""
import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--landmarks", required=True,
                   help="npy with mediapipe landmarks (478,2+)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="point-budget RNG seed (vary for fresh hints)")
    p.add_argument("--out", default="recon.png")
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    args = p.parse_args(argv)

    from PIL import Image

    from smirk_tpu_torch import Predictor

    pred = Predictor(checkpoint=args.checkpoint, use_generator=True, device=args.device)
    img = np.asarray(Image.open(args.image).convert("RGB"))
    kpt = np.load(args.landmarks)[..., :2].astype(np.float32)

    out = pred.reconstruct(img, landmarks=kpt, seed=args.seed)

    panel = np.concatenate(
        [np.clip(out[k][0], 0, 1)
         for k in ("cropped_img", "rendered_img", "masked_img", "reconstructed_img")],
        axis=1)
    Image.fromarray((panel * 255).astype(np.uint8)).save(args.out)
    print(f"wrote {args.out}  [input | render | masked | reconstruction]")


if __name__ == "__main__":
    main()
