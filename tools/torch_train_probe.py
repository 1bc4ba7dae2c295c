"""Probe the training step of one checkout of the PyTorch port on the card.

Runs `SmirkSystem.train_step` at the training recipe's batch (--batch,
32, 224 px, fp32, TF32 off) on chip_smoke.py's procedural head and seeded random
weights, imports `smirk_tpu_torch` from the checkout given by --tree, and
prints one JSON object:

- `train_ms`: per freeze parity, the sorted ms per step of --windows warm
  windows of --steps back-to-back steps (host clock, each window ended by
  a synchronize); the parities alternate window by window, so a drift of
  the host touches both;
- `profile`: per parity, one step under torch.profiler: wall ms, device
  busy ms (the CUDA kernels' self time), the host's CUDA runtime calls by
  name (launches, synchronisations, copies, allocations), the number of
  aten operations and their summed self CPU ms, and the 15 operations
  with the most self CPU time;
- `raster_ms`: the training raster's forward on detached inputs
  (`rasterizer._v5_impl`: binning, layout, records, K3; the step runs it
  once) and the fused inference raster (`rasterize_normals_fused`, the
  cycle path's render; once a step) on the step's faces: ms per call
  between CUDA events around 50 back-to-back calls (the device's timeline,
  so it includes the device waiting on the host), and host ms per call to
  enqueue them (close to the first when the host sets the pace).

Compare two checkouts in one call on one card, in alternating order:

    python3 tools/torch_train_probe.py --tree PARENT --label parent
    python3 tools/torch_train_probe.py --tree . --label change
    python3 tools/torch_train_probe.py --tree . --label change
    python3 tools/torch_train_probe.py --tree PARENT --label parent

Exits 2 without a CUDA card.
"""
import argparse
import json
import os
import statistics
import sys
import time

# host-side CUDA API calls counted in the profile
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaStreamWaitEvent", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cudaMalloc", "cudaFree", "cudaHostAlloc",
                 "cudaEventRecord", "cudaEventQuery")


def train_batch(B, S, seed):
    """chip_smoke.py's synthetic training batch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3), np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.ones((B,), bool),
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
        "img_mica": np.zeros((B, 112, 112, 3), np.float32),
    }


def profile_step(system, batch, parity, gen):
    """One warm step under torch.profiler -> dict (see the module doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system.train_step(batch, parity, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        system.train_step(batch, parity, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = 0.0
    runtime = {}
    n_aten = 0
    aten_self = 0.0
    ops = []
    for e in prof.key_averages():
        kind = str(getattr(e, "device_type", "")).split(".")[-1]
        if kind == "CUDA":
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            busy += us / 1e3
            continue
        if e.key in RUNTIME_CALLS:
            runtime[e.key] = {"count": e.count, "self_ms": e.self_cpu_time_total / 1e3}
        elif e.key.startswith("aten::"):
            n_aten += e.count
            aten_self += e.self_cpu_time_total / 1e3
            ops.append((e.self_cpu_time_total / 1e3, e.key, e.count))
    ops.sort(reverse=True)
    return {"wall_ms": wall, "device_busy_ms": busy, "runtime": runtime,
            "aten_ops": n_aten, "aten_self_cpu_ms": aten_self,
            "top_ops": [{"op": k, "count": c, "self_cpu_ms": ms} for ms, k, c in ops[:15]]}


def per_call(fn, n=50):
    """(ms per call between CUDA events, host ms per call to enqueue) over
    n warm back-to-back calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host = (time.perf_counter() - t) / n * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".", help="checkout whose smirk_tpu_torch is probed")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--batch", type=int, default=32, help="the training batch")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from smirk_tpu_torch import kernels
    from smirk_tpu_torch.assets import procedural_bundle
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train.trainer import SmirkSystem

    assert os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__))) == tree
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(force=True)

    B, S = args.batch, 224
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)  # chip_smoke.py's recentring
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    system = SmirkSystem(Config(), bundle)
    batch = train_batch(B, S, 0)
    gen = torch.Generator(device=system.device).manual_seed(0)

    out = {"label": args.label, "tree": args.tree, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0)}
    for p in (0, 1):  # warm both parities
        system.train_step(batch, p, gen)
    torch.cuda.synchronize()
    ms = {0: [], 1: []}
    for _ in range(args.windows):
        for p in (0, 1):
            t = time.perf_counter()
            for _ in range(args.steps):
                system.train_step(batch, p, gen)
            torch.cuda.synchronize()
            ms[p].append((time.perf_counter() - t) / args.steps * 1e3)
    out["train_ms"] = {f"p{p}": {"median": statistics.median(v), "windows": sorted(v)}
                       for p, v in ms.items()}
    out["profile"] = {f"p{p}": profile_step(system, batch, p, gen) for p in (0, 1)}

    renderer = system.renderer
    cap, budget = renderer.bin_capacity, renderer.raster_compact
    with torch.inference_mode():
        bt = system._batch(batch)
        enc = system.encoder(bt["img"])
        verts = system.flame(enc)["vertices"]
        fv, fn = renderer._face_geometry(verts, renderer.project(verts, enc["cam"]))
        fwd = per_call(lambda: R._v5_impl(fv, fn, S, cap, budget))
        fused = per_call(lambda: R.rasterize_normals_fused(fv, fn, S, capacity=cap,
                                                           compact=budget))
    out["raster_ms"] = {"planes_forward": {"events": fwd[0], "host_enqueue": fwd[1]},
                        "fused_call": {"events": fused[0], "host_enqueue": fused[1]}}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
