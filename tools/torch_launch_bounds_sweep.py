"""Time K3 (csrc/raster_planes.cu) at other resident-block counts on the card.

K3's kernel is declared `__launch_bounds__(kThreads, 5)`: at least 5
blocks of 256 threads resident on an SM, which caps it at 48 registers a
thread. This script compiles the source as it stands and with that
minimum replaced (none, 6, 7), all with nvcc at once, prints ptxas's
registers and spills for each, and times each variant through
`rasterizer.raster_planes_windows` on chip_smoke.py's training faces
(batch 32, 224 px, D = 3, the compact budget), checking every variant
bitwise against the plain version. Variants alternate within each of
--reps rounds; each time is CUDA events around --iters calls.

    python3 tools/torch_launch_bounds_sweep.py

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
BOUNDS = "__launch_bounds__(kThreads, 5)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
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
    source = os.path.join(kernels.CSRC_DIR, kernels.LIBRARIES["raster_planes"][0])
    text = open(source).read()
    assert text.count(BOUNDS) == 1, "the kernel's launch bounds moved"
    variants = {"5 (as committed)": BOUNDS, "none": "__launch_bounds__(kThreads)",
                "6": "__launch_bounds__(kThreads, 6)", "7": "__launch_bounds__(kThreads, 7)"}
    out_dir = os.path.join(kernels.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, bounds) in enumerate(variants.items()):
        src = os.path.join(out_dir, f"raster_planes_{i}.cu")
        with open(src, "w") as f:
            f.write(text.replace(BOUNDS, bounds))
        lib = os.path.join(out_dir, f"libraster_planes_{i}.so")
        procs[name] = (subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, ptxas = {}, {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if re.search(r"Used \d+ registers|spill", ln)]
        lib = ctypes.CDLL(path)
        for fn, argtypes in kernels.LIBRARIES["raster_planes"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.smirk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.smirk_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    # chip_smoke.py's faces: the procedural head recentred, seeded random
    # weights, seeded random images
    B, S = args.batch, 224
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    pred = Predictor(bundle=bundle)
    system, renderer = pred.system, pred.system.renderer
    images = np.random.default_rng(0).random((B, S, S, 3), np.float32)
    result = {"ptxas": ptxas, "device": torch.cuda.get_device_name(0), "ms": {}}
    with torch.inference_mode():
        enc = system.encoder(pred._prepare(images, None))
        verts = system.flame(enc)["vertices"]
        fv, fn = renderer._face_geometry(verts, renderer.project(verts, enc["cam"]))
        cap, TX = renderer.bin_capacity, -(-S // R.TILE_COLS)
        bins, counts = R.bin_faces_flat(fv, S, cap)
        kept, _ = R._windows(counts, renderer.raster_compact)
        records = R.planes_records(fv, fn)
        fv = fv.contiguous()
        plain = R.raster_planes_windows_plain(kept, bins, records, S, TX, 3)
        result["chunk_steps"] = int(kept.sum())
        for name, lib in libs.items():
            kernels._loaded["raster_planes"] = lib
            got = R.raster_planes_windows(kept, bins, records, fv, S, TX, 3)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise RuntimeError(f"variant {name} differs from the plain version")
        for _ in range(args.reps):
            for name, lib in libs.items():
                kernels._loaded["raster_planes"] = lib
                call = (lambda: R.raster_planes_windows(kept, bins, records, fv, S, TX, 3))
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
    kernels._loaded.pop("raster_planes", None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
