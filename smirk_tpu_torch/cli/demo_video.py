"""Video tracking demo (the twin of smirk_tpu/cli/demo_video.py): frames in
chunks of --batch, each chunk cropped on the device in one batched warp
and run through `SmirkSystem.infer` in one call, then written as panels
[crop | render (| reconstruction)] and joined into a video.

    python -m smirk_tpu_torch.cli.demo_video --input_path clip.avi \
        --landmarks tracks.npy --crop --batch 32

Video IO uses cv2 when present; otherwise MJPEG-AVI (utils.videoio) or a
directory of frames. Eval-mode batch norm treats every image on its own,
so the last, short chunk runs as it is (no padding to --batch).

The generator branch (`--use_smirk_generator`) reproduces the JAX demo's
own: a fixed budget of int(0.05 * 224 * 224) points, every sampled point a
hint (no per-image budget) and compose_mask's defaults. It differs from
`SmirkSystem.reconstruct`, which the image demo and `Predictor` run.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Iterator

import numpy as np
import torch

# the JAX video demo's hint budget, fixed at 224 px
GEN_POINTS = int(0.05 * 224 * 224)


def iter_frames(path: str) -> Iterator[np.ndarray]:
    if os.path.isdir(path):
        from PIL import Image

        for name in sorted(os.listdir(path)):
            if name.lower().endswith((".png", ".jpg", ".jpeg")):
                yield np.asarray(Image.open(os.path.join(path, name)).convert("RGB"))
        return
    from smirk_tpu_torch.utils import videoio

    if not videoio.have_cv2():
        # cv2-free fallback: MJPEG-AVI demuxed in pure Python (PIL decodes
        # the per-frame JPEGs). mp4/H.264 still needs cv2.
        yield from videoio.iter_mjpeg_avi(path)
        return
    import cv2

    cap = cv2.VideoCapture(path)
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        yield frame[..., ::-1]
    cap.release()


def prepare_chunk(frames, kpts, crop: bool, size: int, device):
    """A chunk of uint8 frames of one shape -> ((n,S,S,3) f32 in [0,1] on
    the device, per-frame landmarks in the prepared frame or None): with
    `crop`, the scale-1.4 landmark crop of the frames that have landmarks
    as one batched warp; the other frames resized."""
    from smirk_tpu_torch.api import _pil_resize
    from smirk_tpu_torch.data import transforms as T

    x = torch.from_numpy(np.stack(frames)).to(device)
    n, H0, W0 = x.shape[:3]
    imgs = torch.empty((n, size, size, 3), device=device)
    kpts_c = [None] * n
    cropped = [i for i, k in enumerate(kpts) if crop and k is not None]
    resized = [i for i in range(n) if i not in cropped]
    if cropped:
        imgs[cropped], _, kc = T.crop_faces(x[cropped].to(torch.float32),
                                            np.stack([kpts[i] for i in cropped]), size)
        for j, i in enumerate(cropped):
            kpts_c[i] = kc[j]
    if resized:
        imgs[resized] = T.div_exact(_pil_resize(x[resized], size).to(torch.float32), 255.0)
        for i in resized:
            if kpts[i] is not None:
                kpts_c[i] = kpts[i][..., :2] * [size / W0, size / H0]
    return imgs, kpts_c


def generator_fn(system):
    """The JAX video demo's generator branch: GEN_POINTS mesh points, all of
    them hints, compose_mask with dilation 10 and its default noise and
    random mask, the generator on [render | masked]."""
    from smirk_tpu_torch.device import fp32_math
    from smirk_tpu_torch.masking import masking as M

    @fp32_math()
    @torch.inference_mode()
    def run(imgs, out, hulls, seed):
        gen = torch.Generator(device=imgs.device).manual_seed(seed)
        npts, _ = M.sample_mesh_points(
            out["transformed_vertices"], system.flame.faces, system.face_probabilities,
            GEN_POINTS, imgs.shape[1], incidence=system.flame_incidence, generator=gen)
        extra = M.transfer_pixels(imgs, npts, npts)
        masked = M.compose_mask(imgs, hulls, extra, dilation_radius=10,
                                rendered_mask=out["rendered_mask"], generator=gen)
        system.generator.eval()
        return system.generator(torch.cat([out["rendered_img"], masked], -1),
                                system.compute_dtype)

    return run


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_path", required=True,
                   help="video file or directory of frames")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--landmarks", default=None,
                   help="npy of per-frame mediapipe landmarks (N,478,2+)")
    p.add_argument("--crop", action="store_true")
    p.add_argument("--out_path", default="output")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--render_orig", action="store_true")
    p.add_argument("--use_smirk_generator", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' runs the "
                        "plain versions)")
    args = p.parse_args(argv)

    from smirk_tpu_torch.cli.demo import build_system, get_landmarks
    from smirk_tpu_torch.data import transforms as T
    from smirk_tpu_torch.utils.viz import save_image

    system = build_system(args.checkpoint, args.use_smirk_generator, args.device)
    dev, S = system.device, system.config.image_size
    tracks = np.load(args.landmarks) if args.landmarks else None
    gen_fn = (generator_fn(system) if args.use_smirk_generator
              and system.generator is not None else None)
    os.makedirs(args.out_path, exist_ok=True)
    frames, kpts = [], []
    fps_frames, fps_time, chunks = 0, 0.0, 0

    def flush(idx0: int):
        nonlocal fps_frames, fps_time, chunks
        if not frames:
            return
        t0 = time.perf_counter()
        imgs, kpts_c = prepare_chunk(frames, kpts, args.crop, S, dev)
        out = system.infer(imgs)
        recon = None
        if gen_fn is not None:
            hulls = torch.ones((len(frames), S, S), device=dev)  # 1 = background
            have = [i for i, k in enumerate(kpts_c) if k is not None]
            if have:
                hulls[have] = T.convex_hull_mask([kpts_c[i] for i in have], (S, S), dev)
            recon = gen_fn(imgs, out, hulls[..., None], idx0)
        _sync(dev)
        if chunks:  # the first chunk builds cuDNN plans and warms the caches
            fps_time += time.perf_counter() - t0
            fps_frames += len(frames)
        chunks += 1
        cols = [imgs, out["rendered_img"]] + ([recon] if recon is not None else [])
        panels = torch.cat(cols, dim=2).cpu().numpy()
        for i, pnl in enumerate(panels):
            save_image(pnl, os.path.join(args.out_path, f"frame_{idx0 + i:06d}.jpg"))
        frames.clear()
        kpts.clear()

    done = 0
    for fi, frame in enumerate(iter_frames(args.input_path)):
        kpt = tracks[fi] if tracks is not None else get_landmarks(frame, None)
        if frames and frame.shape != frames[0].shape:
            flush(done)
            done = fi
        frames.append(np.ascontiguousarray(frame))
        kpts.append(None if kpt is None else np.asarray(kpt)[..., :2])
        if len(frames) == args.batch:
            flush(done)
            done = fi + 1
    flush(done)
    if fps_time > 0:
        print(f"device fps: {fps_frames / fps_time:.1f} "
              f"({fps_frames} frames, {fps_time:.2f}s device time)")
    _assemble_mp4(args.out_path)


def _assemble_mp4(out_dir: str) -> None:
    """Join the written frame panels into grid.mp4 (cv2) or grid.avi (the
    pure-Python MJPEG muxer)."""
    from smirk_tpu_torch.utils import videoio

    frames = sorted(
        f for f in os.listdir(out_dir)
        if f.startswith("frame_") and f.endswith(".jpg")
    )
    if not frames:
        return
    if not videoio.have_cv2():
        from PIL import Image

        videoio.write_mjpeg_avi(
            os.path.join(out_dir, "grid.avi"),
            (np.asarray(Image.open(os.path.join(out_dir, f)).convert("RGB"))
             for f in frames),
        )
        print("wrote", os.path.join(out_dir, "grid.avi"))
        return
    import cv2

    first = cv2.imread(os.path.join(out_dir, frames[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(
        os.path.join(out_dir, "grid.mp4"),
        cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h),
    )
    for f in frames:
        vw.write(cv2.imread(os.path.join(out_dir, f)))
    vw.release()
    print("wrote", os.path.join(out_dir, "grid.mp4"))


if __name__ == "__main__":
    main()
