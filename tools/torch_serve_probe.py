"""Probe where a served inference artifact's call time goes on the card,
beside `SmirkSystem.infer` on the same images.

Builds chip_smoke.py's main-path system (the default Config, the full-size
recentred procedural head, seeded weights) at --batch (64, 224 px), exports
it with `serving.export_inference`, loads it with `serving.load_inference`
and prints one JSON object:

- `windows_ms`: sorted ms per call of --windows warm windows of --calls
  back-to-back calls (host clock, each window ended by a synchronize) for
  `served` (the loaded callable), `graph` (its graph module called
  directly under the same inference mode and fp32 pin, without the
  callable's input placement) and `infer`, in turns window by window;
- `per_call`: for each, ms per call between CUDA events around 20
  back-to-back calls (the device's timeline) and host ms per call to
  enqueue them (close to the first when the host sets the pace);
- `slowest_call_ms`: per variant, the slowest single call of each window;
- `profile`: after one discarded profiler session (the profiler's own
  warm-up), one warm call of `infer`, `served`, `infer`, `served` under
  torch.profiler, each: wall ms, device busy ms (the CUDA kernels' self
  time), kernel launches, the host's CUDA runtime calls by name, the aten
  operations (count, summed self CPU ms) and the 15 with the most self CPU
  time;
- `kernel_diff`: the device kernels whose count or summed time differ
  between the second profiled served call and `infer` (the 20 largest time
  differences);
- `op_diff`: the aten operations whose count differs between the two;
- `dispatch_us`: host microseconds per call to enqueue small CUDA ops
  (`add`, `mul` by a scalar, a 3x3 `conv2d`) through the eager bindings
  (`torch.add`, `*`, `F.conv2d`, as the module's Python calls them) and
  through `torch.ops.aten.<op>.<overload>` (as an exported graph calls
  them), under inference mode, 2000 calls each, alternated three times.

The loaded graph's Python is written to --code (read it beside the diff).

    python3 tools/torch_serve_probe.py --out serve_probe.json

Exits 2 without a CUDA card.
"""
import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

# host-side CUDA API calls counted in the profile
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaStreamWaitEvent", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cudaMalloc", "cudaFree", "cudaHostAlloc",
                 "cudaEventRecord", "cudaEventQuery")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def profile_call(fn):
    """One warm call under torch.profiler -> (summary dict, {kernel: (count,
    device ms)}, {aten op: count})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels, aten, runtime, ops = {}, {}, {}, []
    busy = aten_self = 0.0
    for e in prof.key_averages():
        kind = str(getattr(e, "device_type", "")).split(".")[-1]
        if kind == "CUDA":
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            busy += us / 1e3
            kernels[e.key] = (e.count, us / 1e3)
            continue
        if e.key in RUNTIME_CALLS:
            runtime[e.key] = {"count": e.count, "self_ms": e.self_cpu_time_total / 1e3}
        elif e.key.startswith("aten::"):
            aten[e.key] = e.count
            aten_self += e.self_cpu_time_total / 1e3
            ops.append((e.self_cpu_time_total / 1e3, e.key, e.count))
    ops.sort(reverse=True)
    summary = {"wall_ms": wall, "device_busy_ms": busy,
               "launches": sum(runtime.get(k, {}).get("count", 0) for k in LAUNCHES),
               "runtime": runtime, "aten_ops": sum(aten.values()),
               "aten_self_cpu_ms": aten_self,
               "top_ops": [{"op": k, "count": c, "self_cpu_ms": ms} for ms, k, c in ops[:15]]}
    return summary, kernels, aten


def dispatch_us(n=2000, rounds=3):
    """{op: {"eager": [us], "aten_overload": [us]}}: host us per call to
    enqueue `n` calls of a small CUDA op each way, `rounds` times in turn."""
    import torch
    import torch.nn.functional as F

    a = torch.rand(64, 64, device="cuda")
    b = torch.rand(64, 64, device="cuda")
    x = torch.rand(1, 8, 16, 16, device="cuda")
    w = torch.rand(8, 8, 3, 3, device="cuda")
    aten = torch.ops.aten
    pairs = {
        "add": (lambda: torch.add(a, b), lambda: aten.add.Tensor(a, b)),
        "mul_scalar": (lambda: a * 2.0, lambda: aten.mul.Tensor(a, 2.0)),
        "conv2d": (lambda: F.conv2d(x, w, None, 1, 1),
                   lambda: aten.conv2d.default(x, w, None, [1, 1], [1, 1], [1, 1], 1)),
    }
    out = {k: {"eager": [], "aten_overload": []} for k in pairs}
    with torch.inference_mode():
        for _ in range(rounds):
            for k, (eager, overload) in pairs.items():
                for name, fn in (("eager", eager), ("aten_overload", overload)):
                    fn()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(n):
                        fn()
                    out[k][name].append((time.perf_counter() - t) / n * 1e6)
                    torch.cuda.synchronize()
    return out


def per_call(fn, n=20):
    """(ms per call between CUDA events, host ms per call to enqueue) over
    n warm back-to-back calls."""
    import torch

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
    return {"events_ms": start.elapsed_time(end) / n, "host_enqueue_ms": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--code", default=None, help="write the loaded graph's Python here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from smirk_tpu_torch import kernels, serving
    from smirk_tpu_torch.assets import procedural_bundle
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.device import fp32_math
    from smirk_tpu_torch.train.trainer import SmirkSystem

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    B, S = args.batch, 224
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)  # chip_smoke.py's recentring
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    system = SmirkSystem(Config(), bundle, training=False)
    img = torch.from_numpy(np.random.default_rng(0).random((B, S, S, 3), np.float32)).cuda()

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serve_probe_", dir=kernels.BUILD_DIR)
    path = serving.export_inference(system, os.path.join(tmp, "inf"), batch_size=B)
    call = serving.load_inference(path)
    gm = call.modules[0]
    if args.code:
        os.makedirs(os.path.dirname(os.path.abspath(args.code)), exist_ok=True)
        with open(args.code, "w") as f:
            f.write(gm.code)
    shutil.rmtree(tmp, ignore_errors=True)  # the program is in memory

    def graph():
        with torch.inference_mode(), fp32_math():
            return gm(img)

    fns = {"served": lambda: call(img), "graph": graph, "infer": lambda: system.infer(img)}
    want = system.infer(img)
    got = call(img)
    out = {"torch": torch.__version__, "device": torch.cuda.get_device_name(0), "batch": B,
           "bitwise": all(torch.equal(got[k], want[k]) for k in serving.OUTPUT_KEYS)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {k: [] for k in fns}
    slowest = {k: [] for k in fns}
    for _ in range(args.windows):
        for k, fn in fns.items():
            calls = []
            t = time.perf_counter()
            for _ in range(args.calls):
                t1 = time.perf_counter()
                fn()
                calls.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t) / args.calls * 1e3)
            slowest[k].append(max(calls))
    out["windows_ms"] = {k: {"median": statistics.median(v), "windows": sorted(v)}
                         for k, v in ms.items()}
    out["slowest_call_ms"] = slowest
    out["per_call"] = {k: per_call(fn) for k, fn in fns.items()}
    profile_call(fns["infer"])  # the profiler's own first-session costs
    prof = [(k, profile_call(fns[k])) for k in ("infer", "served", "infer", "served")]
    out["profile"] = [{"fn": k, **v[0]} for k, v in prof]
    ki, ks = prof[2][1][1], prof[3][1][1]
    diff = []
    for name in set(ks) | set(ki):
        (cs, ts), (ci, ti) = ks.get(name, (0, 0.0)), ki.get(name, (0, 0.0))
        if cs != ci or abs(ts - ti) > 0.05:
            diff.append((abs(ts - ti), name[:120], cs, ci, ts, ti))
    diff.sort(reverse=True)
    out["kernel_diff"] = [{"kernel": n, "served": [cs, ts], "infer": [ci, ti]}
                          for _, n, cs, ci, ts, ti in diff[:20]]
    a_i, a_s = prof[2][1][2], prof[3][1][2]
    out["op_diff"] = {k: [a_s.get(k, 0), a_i.get(k, 0)] for k in sorted(set(a_s) | set(a_i))
                      if a_s.get(k, 0) != a_i.get(k, 0)}
    out["dispatch_us"] = dispatch_us()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
