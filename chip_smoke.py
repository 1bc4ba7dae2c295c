#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (smirk_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # full run, batch 64, 224 px, fp32
    python3 chip_smoke.py --quick    # build + kernel checks at batch 8 only

Phases (any failure exits non-zero):
 1. the device: name, count, and `nvidia-smi` name + power limit;
 2. build the CUDA kernels from csrc/ with nvcc (one process per source,
    all at once) and print ptxas's registers / shared memory / spills;
 3. K2 compact_faces vs its plain PyTorch version at the main path's
    shapes: bitwise equal;
 4. K1 raster_fused_windows on the compact layout and on the padded layout
    (K1b) vs the plain version: pix_to_face, zbuf and normals bitwise
    equal; compact == padded when nothing overflows; a truncated budget
    (24 chunks) overflows and renders its trailing tiles empty;
 5. the main path through `Predictor` at full width (three full
    MobileNetV3-minimal encoders, FLAME with 300 shape / 50 expression
    components on the full-size procedural head, batch 64, 224 px), random
    init, with the face recentred as bench.py's cam_fix does: coverage
    > 5 %, raster_overflow == 0, every output finite, the kernels'
    launch counters rose; then the padded layout's path
    (raster_compact=0); then the card's outputs against the port's plain
    CPU path on a small input;
 6. timings, warm, each beside the card's name and power limit: with CUDA
    events each kernel, its plain version, K2's library yardstick (one
    advanced-index gather) and the stages of infer; on the host clock the
    median and spread of 5 windows of 50 infer calls (ms/batch, images/s)
    and of 3 windows of 20 Predictor calls; occupied chunks vs the budget;
 7. a `kernels` JSON line; 8. the last line, {"ok": true, "device": ...}.

The weights are random (seeded) and the FLAME assets are a procedural
stand-in (smirk_tpu_torch.assets.procedural_bundle) at FLAME's sizes.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth; used for each kernel's bound.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# ~fp32 operations of one face-pixel test: 4 affine forms x (2 mul + 2 add)
OPS_PER_FACE_PIXEL = 16
OPS_PER_NORMAL_PIXEL = 12  # the winner's 3 normal planes
# end-to-end timing: windows x calls per window
INFER_WINDOWS, INFER_CALLS = 5, 50
CALL_WINDOWS, CALL_CALLS = 3, 20


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call on the card, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_windows(fn, n_windows: int, n_calls: int) -> list:
    """Sorted ms per call of `n_windows` warm windows of `n_calls`
    back-to-back calls, each ended by a synchronize (host clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n_windows):
        t = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) / n_calls * 1e3)
    return sorted(ms)


def spread(ms: list) -> float:
    """(max - min) / median, in %."""
    return (ms[-1] - ms[0]) / statistics.median(ms) * 100


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at batch 8, then stop")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from smirk_tpu_torch import Predictor, kernels
        from smirk_tpu_torch.assets import procedural_bundle
        from smirk_tpu_torch.render import rasterizer as R
    except ImportError as e:
        print(f"chip_smoke: the smirk_tpu_torch package is not here ({e})",
              file=sys.stderr)
        return 2

    # ---------------- 1. device ----------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"[1] device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log("nvidia-smi name,power.limit:")
    log(smi)
    card = f"[{smi}]"

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    report = kernels.build(force=True)
    log(f"[2] built {sorted(report)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for lib, rep in sorted(report.items()):
        for line in rep["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {lib}: {line.strip()}")

    # ---------------- main-path inputs ----------------
    B = 8 if args.quick else 64
    S = 224
    bundle = procedural_bundle(seed=0, full_size=True)
    # bench.py's cam_fix: random-init weights leave cam = [7, 0, 0], so
    # the face region is recentred onto the optical axis (here in the
    # template, the same translation before the cam scale)
    vt = np.array(bundle["v_template"], np.float32)
    centre = vt[np.asarray(bundle["face_vertex_ids"])].mean(0)
    vt[:, :2] -= centre[:2]
    bundle["v_template"] = vt
    pred = Predictor(bundle=bundle)  # device None = the card
    system = pred.system
    renderer = system.renderer
    log(f"    bundle V={vt.shape[0]} F={bundle['faces'].shape[0]}; render F="
        f"{renderer.faces.shape[0]} capacity {renderer.bin_capacity} budget "
        f"{renderer.raster_compact}")
    images = np.random.default_rng(0).random((B, S, S, 3), np.float32)
    img = pred._prepare(images, None)

    with torch.inference_mode():
        enc = system.encoder(img)
        fl = system.flame(enc)
        tv = renderer.project(fl["vertices"], enc["cam"])
        face_verts, face_normals = renderer._face_geometry(fl["vertices"], tv)
        cap = renderer.bin_capacity
        CPT = cap // R.V3_CHUNK
        TX = -(-S // R.TILE_COLS)
        bins, counts = R.bin_faces_flat(face_verts, S, cap)
        Tp = bins.shape[1]
        records = R.fused_records(face_verts, face_normals)
        budget = -(-renderer.raster_compact // 8) * 8
        starts, ends, tof, total, dropped = R._compact_plan(counts, budget)
        bins3 = bins.reshape(B, Tp * CPT, R.V3_CHUNK)

        # ---------------- 3. K2 ----------------
        log(f"[3] K2 compact_faces at B={B} Tp={Tp} cpt={CPT} budget={budget}")
        k2 = R.compact_faces(tof, starts, total, bins3, CPT)
        k2_plain = R.compact_faces_plain(tof, starts, total, bins3, CPT)
        torch.cuda.synchronize()
        check(torch.equal(k2, k2_plain), "K2 == plain (bitwise)")
        k2_err = int((k2 - k2_plain).abs().max())

        # ---------------- 4. K1 / K1b ----------------
        log("[4] K1 raster_fused_windows, compact and padded layouts")
        recs_c = R._gather_recs(records, k2.reshape(B, budget * R.V3_CHUNK)).contiguous()
        k1 = R.raster_fused_windows(starts, ends, recs_c, S, TX)
        k1_plain = R.raster_fused_windows_plain(starts, ends, recs_c, S, TX)
        torch.cuda.synchronize()
        k1_err = 0.0
        for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), k1, k1_plain):
            check(torch.equal(a, b), f"K1 {nm} == plain (bitwise)")
            k1_err = max(k1_err, float((a.double() - b.double()).abs().max()))
        ps, pe = R.padded_windows(counts, CPT)
        recs_p = R._gather_recs(records, bins.reshape(B, Tp * cap)).contiguous()
        k1b = R.raster_fused_windows(ps, pe, recs_p, S, TX)
        k1b_plain = R.raster_fused_windows_plain(ps, pe, recs_p, S, TX)
        torch.cuda.synchronize()
        k1b_err = 0.0
        for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), k1b, k1b_plain):
            check(torch.equal(a, b), f"K1b (padded) {nm} == plain (bitwise)")
            k1b_err = max(k1b_err, float((a.double() - b.double()).abs().max()))
        check(int(dropped.max()) == 0, f"no overflow at the budget {budget}")
        for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), k1, k1b):
            check(torch.equal(a, b), f"compact {nm} == padded {nm}")
        # truncated budget: overflow from the plan, trailing tiles empty
        tb = 24
        ts, te, ttof, ttot, tdrop = R._compact_plan(counts, tb)
        tk2 = R.compact_faces(ttof, ts, ttot, bins3, CPT)
        check(torch.equal(tk2, R.compact_faces_plain(ttof, ts, ttot, bins3, CPT)),
              f"K2 == plain at budget {tb}")
        trecs = R._gather_recs(records, tk2.reshape(B, tb * R.V3_CHUNK)).contiguous()
        tk1 = R.raster_fused_windows(ts, te, trecs, S, TX)
        tk1_plain = R.raster_fused_windows_plain(ts, te, trecs, S, TX)
        for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), tk1, tk1_plain):
            check(torch.equal(a, b), f"K1 {nm} == plain at budget {tb}")
        occupied = ((counts + 31) // 32).sum(1)
        check(torch.equal(tdrop, (occupied - tb).clamp_min(0).to(torch.int32))
              and int(tdrop.min()) > 0, f"overflow at budget {tb} = occupied - {tb} "
              f"(min {int(tdrop.min())}, max {int(tdrop.max())})")
        _, _, _, ovf = R.rasterize_normals_fused(
            face_verts, face_normals, S, capacity=cap, compact=tb,
            return_overflow=True)
        check(torch.equal(ovf, tdrop), "rasterize_normals_fused overflow == plan's")
        empty = (te - ts) == 0  # tiles clipped past the budget
        check(bool((tk1[0][empty] == -1).all()) and bool(empty.any()),
              f"{int(empty.sum())} clipped tiles render empty")
        keep = ~empty
        check(torch.equal(tk1[0][keep & (te == ends)], k1[0][keep & (te == ends)]),
              "tiles inside the truncated budget equal the full render")

    if args.quick:
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": count}}))
        return 0

    # ---------------- 5. main path ----------------
    log(f"[5] main path: Predictor -> SmirkSystem.infer at b{B}, {S} px, fp32")
    R.reset_launch_counts()
    out = pred(images)
    launches = {"compact_faces": R.compact_faces.launches,
                "raster_fused_windows": R.raster_fused_windows.launches}
    log(f"    launches on the main path: {launches}")
    check(launches["compact_faces"] > 0 and launches["raster_fused_windows"] > 0,
          "the main path went through K1 and K2")
    coverage = float(out["rendered_mask"].mean())
    check(coverage > 0.05, f"coverage {coverage:.4f} > 0.05")
    check(int(out["raster_overflow"].max()) == 0, "raster_overflow == 0")
    for k, v in out.items():
        check(np.isfinite(v).all(), f"{k} {v.shape} finite")
    check(out["rendered_img"].shape == (B, S, S, 3) and out["vertices"].shape ==
          (B, vt.shape[0], 3), "output shapes")

    log("    padded layout path: Predictor(raster_compact=0)")
    pred_pad = Predictor(bundle=bundle, raster_compact=0)
    pred_pad.system.encoder.load_state_dict(system.encoder.state_dict())
    R.reset_launch_counts()
    out_pad = pred_pad(images)
    launches_pad = {"compact_faces": R.compact_faces.launches,
                    "raster_fused_windows": R.raster_fused_windows.launches}
    log(f"    launches on the padded path: {launches_pad}")
    check(launches_pad["raster_fused_windows"] > 0 and launches_pad["compact_faces"] == 0,
          "the padded path went through K1 only")
    check(np.array_equal(out_pad["pix_to_face"], out["pix_to_face"])
          and np.array_equal(out_pad["rendered_img"], out["rendered_img"]),
          "padded path == compact path")

    log("    against the port's plain CPU path on 2 images")
    pred_cpu = Predictor(bundle=bundle, device="cpu")
    pred_cpu.system.encoder.load_state_dict(system.encoder.state_dict())
    ref = pred_cpu(images[:2])
    got = pred(images[:2])
    for k in ("pose_params", "cam", "shape_params", "expression_params",
              "eyelid_params", "jaw_params", "vertices", "landmarks_fan",
              "landmarks_mp"):
        err = float(np.abs(ref[k] - got[k]).max())
        check(err < 1e-4, f"{k} card vs cpu max |diff| {err:.2e} < 1e-4")
    agree = float((ref["pix_to_face"] == got["pix_to_face"]).mean())
    check(agree >= 0.995, f"pix_to_face card vs cpu agree on {agree:.5f} >= 0.995")

    # ---------------- 6. timings ----------------
    log(f"[6] timings {card}")
    res = {}
    with torch.inference_mode():
        res["k2_ms"] = cuda_ms(lambda: R.compact_faces(tof, starts, total, bins3, CPT), 200)
        res["k2_plain_ms"] = cuda_ms(
            lambda: R.compact_faces_plain(tof, starts, total, bins3, CPT), 50)
        rows = (tof * CPT + torch.arange(budget, device=tof.device)[None]
                - torch.gather(starts, 1, tof.long())).clamp(0, Tp * CPT - 1).long()
        bidx = torch.arange(B, device=tof.device)[:, None]
        # yardstick: one advanced-index gather of the same source rows
        res["k2_library_ms"] = cuda_ms(lambda: bins3[bidx, rows], 200)
        res["k1_ms"] = cuda_ms(lambda: R.raster_fused_windows(starts, ends, recs_c, S, TX), 50)
        res["k1_plain_ms"] = cuda_ms(
            lambda: R.raster_fused_windows_plain(starts, ends, recs_c, S, TX), 5, 1)
        res["k1b_ms"] = cuda_ms(lambda: R.raster_fused_windows(ps, pe, recs_p, S, TX), 50)
        res["k1b_plain_ms"] = cuda_ms(
            lambda: R.raster_fused_windows_plain(ps, pe, recs_p, S, TX), 5, 1)
        def records_plan_k2_gather():
            s, e, tf, tt, _ = R._compact_plan(counts, budget)
            f = R.compact_faces(tf, s, tt, bins3, CPT)
            return R._gather_recs(R.fused_records(face_verts, face_normals),
                                  f.reshape(B, budget * R.V3_CHUNK))

        # stage breakdown of one infer call (K1 itself is k1_ms above)
        stages = {
            "encoder": lambda: system.encoder(img),
            "flame": lambda: system.flame(enc),
            "render_inference": lambda: renderer.render_inference(fl["vertices"], tv),
            "face_geometry": lambda: renderer._face_geometry(fl["vertices"], tv),
            "bin_faces_flat": lambda: R.bin_faces_flat(face_verts, S, cap),
            "records_plan_k2_gather": records_plan_k2_gather,
        }
        for k, fn in stages.items():
            res[f"stage_{k}_ms"] = cuda_ms(fn, 10)
    # end to end: warm windows of back-to-back calls, each window ended by a
    # synchronize, on the host clock; the median window and the spread
    infer_w = timed_windows(lambda: system.infer(img), INFER_WINDOWS, INFER_CALLS)
    call_w = timed_windows(lambda: pred(images), CALL_WINDOWS, CALL_CALLS)
    infer_ms, call_ms = statistics.median(infer_w), statistics.median(call_w)
    occ = renderer.measure_compact_occupancy(fl["vertices"], enc["cam"])
    for k, v in res.items():
        log(f"    {k:32s} {v:10.4f} ms {card}")
    log(f"    infer ms/batch{B} median {infer_ms:.3f} over {INFER_WINDOWS} windows of "
        f"{INFER_CALLS} calls (min {infer_w[0]:.3f}, max {infer_w[-1]:.3f}, spread "
        f"{spread(infer_w):.1f} %)  images/s {B / infer_ms * 1e3:.1f} {card}")
    log(f"    Predictor.__call__ ms/batch{B} (host preparation + D2H included) median "
        f"{call_ms:.3f} over {CALL_WINDOWS} windows of {CALL_CALLS} calls (min "
        f"{call_w[0]:.3f}, max {call_w[-1]:.3f}, spread {spread(call_w):.1f} %)  "
        f"images/s {B / call_ms * 1e3:.1f} {card}")
    log(f"    occupied chunks (max over images) {occ['occupied_chunks']} vs budget "
        f"{occ['budget']} (headroom {occ['headroom']:.3f}); mean "
        f"{float(occupied.float().mean()):.1f}")

    # ---------------- 7. kernels line ----------------
    win_c = int((ends - starts).sum())
    win_p = int((pe - ps).sum())

    def k1_bound(win, n_in_tiles):
        ops = win * 32 * R.TILE_PIX * OPS_PER_FACE_PIXEL + \
            n_in_tiles * R.TILE_PIX * OPS_PER_NORMAL_PIXEL
        nbytes = 2 * B * Tp * 4 + win * 32 * 32 * 4 + 5 * B * Tp * R.TILE_PIX * 4
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    n_tiles = B * Tp
    k1_bms, k1_by = k1_bound(win_c, n_tiles)
    k1b_bms, k1b_by = k1_bound(win_p, n_tiles)
    k2_bytes = (B * budget * 4 + B * Tp * 4 + B * 4 + int(total.sum()) * 32 * 4
                + B * budget * 32 * 4)
    src = "smirk_tpu_torch/csrc/"
    line = {"kernels": [
        {"name": "compact_faces", "route": "cuda", "source": src + "compact_faces.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1257",
         "launches": launches["compact_faces"], "max_abs_err": k2_err,
         "ms": res["k2_ms"], "plain_ms": res["k2_plain_ms"],
         "bound_ms": k2_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": res["k2_library_ms"]},
        {"name": "raster_fused_windows", "route": "cuda", "source": src + "raster_fused.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1331",
         "launches": launches["raster_fused_windows"], "max_abs_err": k1_err,
         "ms": res["k1_ms"], "plain_ms": res["k1_plain_ms"],
         "bound_ms": k1_bms, "bound_by": k1_by, "library_ms": None},
        {"name": "raster_fused_windows (padded layout)", "route": "cuda",
         "source": src + "raster_fused.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1157",
         "launches": launches_pad["raster_fused_windows"], "max_abs_err": k1b_err,
         "ms": res["k1b_ms"], "plain_ms": res["k1b_plain_ms"],
         "bound_ms": k1b_bms, "bound_by": k1b_by, "library_ms": None},
    ]}
    for k in line["kernels"]:
        assert all(isinstance(k[f], (int, float)) and math.isfinite(k[f])
                   for f in ("ms", "plain_ms", "bound_ms", "max_abs_err"))
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
