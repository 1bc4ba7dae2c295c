"""Time a kernel of the port at other resident-block counts on the card.

Each kernel is declared with `__launch_bounds__(kThreads[, N])`: at least N
blocks of 256 threads resident on an SM, which caps its registers a thread.
This script compiles the chosen kernel's source as it stands and with that
minimum replaced (none, 4, 5, 6, 7; K7 also 8), all with nvcc at once,
prints ptxas's registers and spills for each, and times each variant
through its wrapper on chip_smoke.py's faces, checking every variant
against the plain version (bitwise; K7 within 1e-5 x the sum of the
magnitudes of its terms). Variants alternate within each of --reps rounds;
each time is CUDA events around --iters calls. The kernels:

    planes  K3 raster_planes_windows (csrc/raster_planes.cu): the training
            faces, batch 32, 224 px, D = 3, the compact budget;
    fused   K1 raster_fused_windows (csrc/raster_fused.cu): the inference
            faces, batch 64, 224 px, the compact budget;
    bins    K8 raster_bins_coverage (csrc/raster_bins.cu): the same faces,
            batch 32, capacity 384; one more variant, at the committed
            minimum, drops the sign test that skips the divisions, so that
            every tested pair divides;
    coverage
            K6 raster_coverage_windows (csrc/raster_coverage.cu): the same
            faces, batch 32, capacity 512, the padded layout (the op path's);
    reduce  K7 segment_reduce_tiles (csrc/segment_reduce.cu): K6's slots on
            those faces, tile-major, and a seeded 36-channel payload (the
            op path's D = 9) with NaN in the rows of dropped slots, C = 512;
            three more variants load 1 or 4 entries' rows (kSteps, 2 as
            committed) before they are summed, or add every entry's row to
            the accumulators (no sums in registers over a repeated slot). The committed kernel is also timed on inputs that
            take its phases apart ("probes"): every slot -1 (the zero fill,
            the slot reads and the store alone), a zero payload on K6's
            slots (the rows read, no atomic), and every slot drawn in
            [0, C) (every row read and added);
    moments K4 (csrc/segment_moments.cu): K3's slots on the planes faces,
            batch 32, C = 384, and a seeded cotangent, D = 3; each variant
            runs the store epilogue (`segment_moments`), the fold epilogue
            (`segment_moments_to_faces`, where the tree has it) and the
            store followed by K5 (`fold_slots_to_faces`), each checked
            within 1e-5 x the sum of the magnitudes of its terms. Probes of
            the committed kernel: every slot -1 (the zero fill and the
            epilogue alone), a zero cotangent (the walk without atomics);
            the timed inputs are the walk with its atomics. One more
            variant adds every pixel's moments with its own atomics (each
            lane its own peer: no sums over a warp's pixels on one slot);
    fold    K5 fold_slots_to_faces (csrc/fold_faces.cu) at the op path's
            shapes: K7's output on K6's slots, C = 512, 36 channels, with
            NaN in every row of a slot that holds no face (the output must
            stay finite), and at the training shapes: K4's rows, C = 384,
            9 channels; more variants load 1 or 4 pieces a lane (kSteps, 2 as
            committed) before they are added, or add a float4 piece with
            four scalar atomics. Probes at the op path's shapes: every bin
            -1 (the bins read alone), zero rows (the rows read, no atomic).
            A variant whose source line an older tree lacks is listed under
            "variants_absent".

    python3 tools/torch_launch_bounds_sweep.py --kernel fused

Times are {variant: {call: [ms per round]}}; probes {probe: {call: [ms]}}:
"ms" and "probes" with the host launching each call (as chip_smoke.py
times them: a call's Python and launch costs pace a kernel shorter than
them), "device_ms" and "device_probes" from one CUDA graph of the --iters
calls, replayed (the device's time for the call's kernels, the wrapper's
output fill included).

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
               "        if (t <= -kSureE) continue;  // the division skip\n", "")}),
           "coverage": ("raster_coverage", 32, {}),
           "reduce": ("segment_reduce", 32, {
               **{f"kSteps {n}": ("constexpr int kSteps = 2;", f"constexpr int kSteps = {n};")
                  for n in (1, 4)},
               "one atomic per entry": ("if (to[u] != run_to) {", "if (true) {")}),
           "moments": ("segment_moments", 32, {
               "no peer sums": ("__match_any_sync(kFull, live ? s[k] : -1 - lane)",
                                "__match_any_sync(kFull, -1 - lane)")}),
           "fold": ("fold_faces", 32, {
               **{f"kSteps {n}": ("constexpr int kSteps = 2;", f"constexpr int kSteps = {n};")
                  for n in (1, 4)},
               "scalar atomics": (
                   "atomicAdd(reinterpret_cast<float4*>(dst), v);",
                   "atomicAdd(dst, v.x); atomicAdd(dst + 1, v.y); atomicAdd(dst + 2, v.z); "
                   "atomicAdd(dst + 3, v.w);")})}
MINIMA = (None, 4, 5, 6, 7)
# K7's blocks hold 24.6 KB and K4's 15.5 KB at C = 384, D = 3: 8 fit an SM
MORE_MINIMA = {"reduce": (8,), "moments": (8,), "fold": (8,)}


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
    minima = MINIMA + MORE_MINIMA.get(args.kernel, ())
    committed = [n for n in minima if text.count(_bounds(n)) == 1]
    assert len(committed) == 1, "the kernel's launch bounds are not one of the swept forms"
    variants = {("as committed: " if n == committed[0] else "") + str(n or "none"):
                text.replace(_bounds(committed[0]), _bounds(n)) for n in minima}
    absent = []  # variants whose line this source lacks (an older tree's)
    for name, (old, new) in patches.items():
        assert text.count(old) <= 1, f"variant {name}: its source line is not unique"
        if text.count(old):
            variants[name] = text.replace(old, new)
        else:
            absent.append(name)
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
              "device": torch.cuda.get_device_name(0), "variants_absent": absent, "ms": {}}
    with torch.inference_mode():
        enc = system.encoder(pred._prepare(images, None))
        verts = system.flame(enc)["vertices"]
        fv, fn = renderer._face_geometry(verts, renderer.project(verts, enc["cam"]))
        fv = fv.contiguous()
        cap, TX = renderer.bin_capacity, -(-S // R.TILE_COLS)
        bins, counts = R.bin_faces_flat(fv, S, cap)
        kept, _ = R._windows(counts, renderer.raster_compact)
        F = int(renderer.faces.shape[0])
        probes = {}  # probe -> {call: fn}, timed on the committed variant

        def within(got, want, scale):
            return bool(torch.isfinite(got).all()) and bool(
                ((got - want).abs() <= 1e-5 * scale + 1e-30).all())

        if args.kernel in ("planes", "moments", "fold"):
            records = R.planes_records(fv, fn)
            call = (lambda: R.raster_planes_windows(kept, bins, records, fv, S, TX, 3))
            plain = R.raster_planes_windows_plain(kept, bins, records, S, TX, 3)
            slots3, bins3 = plain[2], bins
        if args.kernel == "fused":
            records = R.fused_records(fv, fn)
            call = (lambda: R.raster_fused_windows(kept, bins, records, fv, S, TX))
            plain = R.raster_fused_windows_plain(kept, bins, records, S, TX)
        elif args.kernel == "bins":
            fv9 = fv.reshape(B, -1, 9).contiguous()
            call = (lambda: R.raster_bins_coverage(counts, bins, fv9, S))
            plain = R.raster_bins_coverage_plain(counts, bins, fv9, S)
        elif args.kernel in ("coverage", "reduce", "fold"):
            # the op path's capacity and padded layout
            bins, counts = R.bin_faces_flat(fv, S, 512)
            kept = R._windows(counts, None)[0]
            records = R.coverage_records(fv)
            call = (lambda: R.raster_coverage_windows(kept, bins, records, fv, S, TX))
            plain = R.raster_coverage_windows_plain(kept, bins, records, S, TX)
        calls = {args.kernel: call}
        checks = {args.kernel: lambda got: all(torch.equal(a, b) for a, b in zip(got, plain))}
        if args.kernel in ("reduce", "fold"):
            slots = R.image_to_tiles(R._tiles_to_image(plain[2], S), S).contiguous()
            payload = torch.randn(tuple(slots.shape) + (36,), device=slots.device,
                                  generator=torch.Generator(device=slots.device).manual_seed(7))
            drop = (slots < 0) | (slots >= 512)
            payload = torch.where(drop[..., None], float("nan"), payload)
            result["rows_read"] = int((~drop).sum())
        if args.kernel == "reduce":
            want = R.segment_sum(slots, payload, 512)
            scale = R.segment_sum(slots, payload.abs(), 512)
            calls = {"reduce": lambda: R.segment_reduce_tiles(slots, payload, 512)}
            checks = {"reduce": lambda got: within(got, want, scale)}
            gen = torch.Generator(device=slots.device).manual_seed(8)
            every = torch.randint(0, 512, tuple(slots.shape), device=slots.device,
                                  generator=gen, dtype=torch.int32)
            every_pay = torch.randn(tuple(payload.shape), device=slots.device, generator=gen)
            probes = {
                "every slot -1": (torch.full_like(slots, -1), payload),
                "zero payload": (slots, torch.zeros_like(payload)),
                "every slot in [0, C)": (every, every_pay)}
            probes = {n: {"reduce": lambda sl=sl, pl=pl: R.segment_reduce_tiles(sl, pl, 512)}
                      for n, (sl, pl) in probes.items()}
        if args.kernel in ("moments", "fold"):
            # chip_smoke.py's phase 4c: K3's slots, a seeded cotangent, D = 3
            g = torch.randn((B, S, S, 3), device=fv.device,
                            generator=torch.Generator(device=fv.device).manual_seed(0))
            g_t = R.image_to_tiles(g, S).contiguous()
            moments = R.segment_moments_plain(slots3, g_t, cap, S).contiguous()
            mscale = R.segment_sum(slots3, R.moment_rows(g_t, S).abs(), cap)
            fwant = R.fold_slots_to_faces_plain(moments, bins3, F)
            fscale = R.fold_slots_to_faces_plain(mscale, bins3, F)
            live = (slots3 >= 0) & (slots3 < cap)
            won = torch.zeros((B, bins3[0].numel() + 1), device=fv.device).scatter_(
                1, R.slot_index(slots3, cap, 1)[..., 0], 1.0)[:, :-1]
            result["train_slots"] = {"all": bins3.numel(), "won": int(won.sum()),
                                     "holding_a_face": int((bins3 >= 0).sum()),
                                     "live_pixels": int(live.sum()), "pixels": live.numel()}
        if args.kernel == "moments":
            calls = {"store": lambda: R.segment_moments(slots3, g_t, cap, S),
                     "store + K5": lambda: R.fold_slots_to_faces(
                         R.segment_moments(slots3, g_t, cap, S), bins3, F)}
            checks = {"store": lambda got: within(got, moments, mscale),
                      "store + K5": lambda got: within(got, fwant, fscale)}
            fold = getattr(R, "segment_moments_to_faces", None)  # the parent has none
            if fold is not None:
                calls["fold"] = lambda: fold(slots3, g_t, bins3, cap, S, F)
                checks["fold"] = lambda got: within(got, fwant, fscale)
            minus = torch.full_like(slots3, -1)
            zero = torch.zeros_like(g_t)
            probes = {"every slot -1": {"store": lambda: R.segment_moments(minus, g_t, cap, S)},
                      "zero cotangent": {"store": lambda: R.segment_moments(slots3, zero, cap, S)}}
            if fold is not None:
                probes["every slot -1"]["fold"] = lambda: fold(minus, g_t, bins3, cap, S, F)
                probes["zero cotangent"]["fold"] = lambda: fold(slots3, zero, bins3, cap, S, F)
        if args.kernel == "fold":
            # the op path's K7 -> K5 at C = 512, 36 channels, NaN in every row
            # of a slot that holds no face; the training shapes' K4 rows
            per_slot = R.segment_reduce_tiles(slots, payload, 512)
            per_slot = torch.where((bins < 0)[..., None], float("nan"), per_slot).contiguous()
            owant = R.fold_slots_to_faces_plain(per_slot, bins, F)
            oscale = R.fold_slots_to_faces_plain(per_slot.abs(), bins, F)
            tscale = R.fold_slots_to_faces_plain(moments.abs(), bins3, F)
            result["op_slots"] = {"all": bins.numel(), "holding_a_face": int((bins >= 0).sum())}
            calls = {"op path C=512 CHN=36": lambda: R.fold_slots_to_faces(per_slot, bins, F),
                     "train C=384 CHN=9": lambda: R.fold_slots_to_faces(moments, bins3, F)}
            checks = {"op path C=512 CHN=36": lambda got: within(got, owant, oscale),
                      "train C=384 CHN=9": lambda got: within(got, fwant, tscale)}
            empty = torch.full_like(bins, -1)
            zero_rows = torch.zeros_like(per_slot)
            probes = {"every bin -1": {"op path C=512 CHN=36": lambda: R.fold_slots_to_faces(
                          per_slot, empty, F)},
                      "zero rows": {"op path C=512 CHN=36": lambda: R.fold_slots_to_faces(
                          zero_rows, bins, F)}}
        result["chunk_steps"] = int(kept.sum())
        for name, lib in libs.items():
            kernels._loaded[libname] = lib
            for label, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if not checks[label](got):
                    raise RuntimeError(f"variant {name} differs from the plain version ({label})")

        def timed(fn):
            """(ms per call with the host launching each call, as chip_smoke.py
            times them; device ms per call: the calls captured in one CUDA
            graph and replayed, so no host time lies between launches)."""
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.iters, kernels.graph_ms(fn, args.iters)

        def record(into, name, label, fn):
            host, device = timed(fn)
            result[into].setdefault(name, {}).setdefault(label, []).append(host)
            result["device_" + into].setdefault(name, {}).setdefault(label, []).append(device)

        result["device_ms"] = {}
        for _ in range(args.reps):
            for name, lib in libs.items():
                kernels._loaded[libname] = lib
                for label, fn in calls.items():
                    record("ms", name, label, fn)
        if probes:  # the committed kernel on inputs that part its phases
            kernels._loaded[libname] = libs[next(n for n in libs if n.startswith("as committed"))]
            result["probes"], result["device_probes"] = {}, {}
            for _ in range(args.reps):
                for name, fns in probes.items():
                    for label, fn in fns.items():
                        record("probes", name, label, fn)
    kernels._loaded.pop(libname, None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
