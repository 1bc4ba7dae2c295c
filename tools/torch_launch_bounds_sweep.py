"""Time a window raster of the port at other resident-block counts on the card.

Each kernel is declared with `__launch_bounds__(kThreads[, N])`: at least N
blocks of 256 threads resident on an SM, which caps its registers a thread.
This script compiles the chosen kernel's source as it stands and with that
minimum replaced (none, 4, 5, 6, 7), all with nvcc at once, prints ptxas's
registers and spills for each, and times each variant through its wrapper
on chip_smoke.py's faces, checking every variant bitwise against the plain
version. Variants alternate within each of --reps rounds; each time is
CUDA events around --iters calls. The kernels:

    planes  K3 raster_planes_windows (csrc/raster_planes.cu): the training
            faces, batch 32, 224 px, D = 3, the compact budget;
    fused   K1 raster_fused_windows (csrc/raster_fused.cu): the inference
            faces, batch 64, 224 px, the compact budget;
    bins    K8 raster_bins_coverage (csrc/raster_bins.cu): the same faces,
            batch 32, capacity 384; one more variant, at the committed
            minimum, drops the sign test that skips the divisions, so that
            every tested pair divides.

    python3 tools/torch_launch_bounds_sweep.py --kernel fused

Prints one JSON object. Exits 2 without a CUDA card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel -> (library, default batch, {variant: (source text, replacement)}
# beside the launch bounds, at the committed minimum)
TARGETS = {"planes": ("raster_planes", 32, {}), "fused": ("raster_fused", 64, {}),
           "bins": ("raster_bins", 32, {"every pair divided": (
               "        if (t <= -kSureE) continue;  // the division skip\n", "")})}
MINIMA = (None, 4, 5, 6, 7)


def _bounds(n):
    return "__launch_bounds__(kThreads)" if n is None else f"__launch_bounds__(kThreads, {n})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(TARGETS), default="planes")
    ap.add_argument("--batch", type=int, default=None, help="default: the kernel's")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_launch_bounds_sweep: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    from smirk_tpu_torch import Predictor, kernels
    from smirk_tpu_torch.assets import procedural_bundle
    from smirk_tpu_torch.render import rasterizer as R

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libname, batch, patches = TARGETS[args.kernel]
    source = os.path.join(kernels.CSRC_DIR, kernels.LIBRARIES[libname][0])
    text = open(source).read()
    committed = [n for n in MINIMA if text.count(_bounds(n)) == 1]
    assert len(committed) == 1, "the kernel's launch bounds are not one of the swept forms"
    variants = {("as committed: " if n == committed[0] else "") + str(n or "none"):
                text.replace(_bounds(committed[0]), _bounds(n)) for n in MINIMA}
    for name, (old, new) in patches.items():
        assert text.count(old) == 1, f"variant {name}: its source line moved"
        variants[name] = text.replace(old, new)
    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, variant) in enumerate(variants.items()):
        src = os.path.join(out_dir, f"{libname}_{i}.cu")
        with open(src, "w") as f:
            f.write(variant)
        lib = os.path.join(out_dir, f"lib{libname}_{i}.so")
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, ptxas = {}, {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if re.search(r"Used \d+ registers|spill", ln)]
        lib = ctypes.CDLL(path)
        for fn, argtypes in kernels.LIBRARIES[libname][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.smirk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.smirk_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    # chip_smoke.py's faces: the procedural head recentred, seeded random
    # weights, seeded random images
    B, S = args.batch or batch, 224
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    pred = Predictor(bundle=bundle)
    system, renderer = pred.system, pred.system.renderer
    images = np.random.default_rng(0).random((B, S, S, 3), np.float32)
    result = {"kernel": args.kernel, "batch": B, "ptxas": ptxas,
              "device": torch.cuda.get_device_name(0), "ms": {}}
    with torch.inference_mode():
        enc = system.encoder(pred._prepare(images, None))
        verts = system.flame(enc)["vertices"]
        fv, fn = renderer._face_geometry(verts, renderer.project(verts, enc["cam"]))
        fv = fv.contiguous()
        cap, TX = renderer.bin_capacity, -(-S // R.TILE_COLS)
        bins, counts = R.bin_faces_flat(fv, S, cap)
        kept, _ = R._windows(counts, renderer.raster_compact)
        if args.kernel == "planes":
            records = R.planes_records(fv, fn)
            call = (lambda: R.raster_planes_windows(kept, bins, records, fv, S, TX, 3))
            plain = R.raster_planes_windows_plain(kept, bins, records, S, TX, 3)
        elif args.kernel == "fused":
            records = R.fused_records(fv, fn)
            call = (lambda: R.raster_fused_windows(kept, bins, records, fv, S, TX))
            plain = R.raster_fused_windows_plain(kept, bins, records, S, TX)
        else:
            fv9 = fv.reshape(B, -1, 9).contiguous()
            call = (lambda: R.raster_bins_coverage(counts, bins, fv9, S))
            plain = R.raster_bins_coverage_plain(counts, bins, fv9, S)
        result["chunk_steps"] = int(kept.sum())
        for name, lib in libs.items():
            kernels._loaded[libname] = lib
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise RuntimeError(f"variant {name} differs from the plain version")
        for _ in range(args.reps):
            for name, lib in libs.items():
                kernels._loaded[libname] = lib
                call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    call()
                end.record()
                torch.cuda.synchronize()
                result["ms"].setdefault(name, []).append(start.elapsed_time(end) / args.iters)
    kernels._loaded.pop(libname, None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
