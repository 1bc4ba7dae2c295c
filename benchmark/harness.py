"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json
names its configuration (`benchmark/configs/<config>.json`) and its
traffic (`benchmark/traffic/<traffic>.json`, which names its entry,
`benchmark/entries/<entry>.py`); `benchmark/workloads/<cell>.json` holds
the limits of the numbers that decide `correct`; each per-layer metric is
read by `benchmark/metrics/<metric>.py`.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "smirk_tpu")
# smirk_tpu_torch/bench.py's coverage gate (commit 19e99aba3b04): a render
# covering no more than this share of its pixels is an empty scene
MIN_COVERAGE = 0.05


def read_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict
    traffic: Dict
    spec: Dict  # the cell's own file: the limits of `correct`, how it compares
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def find(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files read by name."""
    manifest = read_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = read_json(root, configs[w["config"]]["file"])
    traffic = read_json(root, "benchmark", "traffic", w["traffic"] + ".json")
    spec = read_json(root, "benchmark", "workloads", name + ".json")

    def mine(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if mine(m) and m["moves"] in reported]
    return Cell(name, w["chips"], cfg, traffic, spec, e2e, per_layer)


@dataclasses.dataclass
class Context:
    cfg: Dict
    traffic: Dict
    spec: Dict
    seed: int
    device: object
    bundle: Dict
    control: bool = False


def entry(cell: Cell, ctx: Context):
    return importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}").Entry(ctx)


def metric_reader(name: str):
    """`read` of benchmark/metrics/<name>.py (a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of all values, linear between closest ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window(call, seconds: float, multiple: int = 1) -> Dict:
    """The measured window: back-to-back calls until `seconds` have passed
    and the count of calls is a multiple of `multiple` (whole cycles of a
    traffic whose calls differ in cost, such as the two freeze parities of
    training); the last call runs to its end. -> every call's seconds, the
    images done, the window's wall and the calling thread's CPU seconds."""
    calls, images = [], 0
    t0, c0 = time.perf_counter(), time.thread_time()
    end = t0
    while True:
        start = time.perf_counter()
        if start - t0 >= seconds and len(calls) % multiple == 0:
            break
        images += call()
        end = time.perf_counter()
        calls.append(end - start)
    return {"call_s": calls, "images": images, "wall_s": end - t0,
            "thread_s": time.thread_time() - c0}


def end_to_end(names, win: Dict, setup_s: float) -> Dict[str, float]:
    out = {"setup_s": setup_s}
    rate = win["images"] / win["wall_s"]
    for n in names:
        if n.endswith("_images_per_s"):
            out[n] = rate
        elif n == "serve_p95_ms":
            out[n] = percentile(win["call_s"], 95) * 1e3
    return {n: out[n] for n in names}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def numbers_line(numbers: Dict[str, float], limits: Dict[str, float], coverage) -> Dict:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    checks["coverage"] = {"value": coverage, "limit": MIN_COVERAGE, "at_least": True}
    return checks


def verdict(checks: Dict) -> bool:
    ok = True
    for c in checks.values():
        v = c["value"]
        if v is None or v != v:
            ok = False
        elif c.get("at_least"):
            ok &= v > c["limit"]
        else:
            ok &= v <= c["limit"]
    return ok


def run(args) -> int:
    cell = find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from smirk_tpu_torch import kernels

    kernels.build()
    from benchmark import head

    out = execute(cell, args, torch.device("cuda", 0), head.head(full_size=True))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 1
    out["result"]["card"] = card()
    finish(out)
    return 0


def execute(cell: Cell, args, device, bundle) -> Dict:
    """Set-up, window, traced slice and check of one run on `device` ->
    {"result": the line without its card and checks, "checks", "record"}."""
    import torch

    cuda = device.type == "cuda"
    ctx = Context(cell.cfg, cell.traffic, cell.spec, args.seed, device, bundle)
    e = entry(cell, ctx)
    e.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - args.t_start

    failed_before = e.failed  # set-up's calls are not the window's
    win = window(e.call, args.seconds, cell.traffic.get("calls_multiple", 1))
    attempted, failed = len(win["call_s"]), e.failed - failed_before
    rec: Dict = {"window": win}
    if args.trace:
        from benchmark import devtrace

        calls = cell.traffic["trace_calls"]
        devtrace.profile(e.call, 1)  # the profiler's own first-use set-up
        rec["slice"] = devtrace.reduce(devtrace.profile(e.call, calls), calls)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    e.release()
    checked = e.check()
    rec.update(checked["record"])
    checks = numbers_line(checked["numbers"], cell.limits, checked["coverage"])
    device_out = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                  "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": verdict(checks), "attempted": attempted, "failed": failed}
    if args.trace:
        s = rec["slice"]
        device_out.update(busy_s=s["busy_s"], window_s=s["window_s"])
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    else:
        values = end_to_end([m["name"] for m in cell.end_to_end], win, setup_s)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    result["device"] = device_out
    calls = win["call_s"]
    result["calls"] = {"count": len(calls), "p50_ms": percentile(calls, 50) * 1e3,
                       "p90_ms": percentile(calls, 90) * 1e3}
    return {"result": result, "checks": checks, "record": rec}


def finish(out: Dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error; the result, the checks last, as the last line on standard
    output."""
    checks = out["checks"]
    for k, c in checks.items():
        rel = ">" if c.get("at_least") else "<="
        print(f"check {k}: {c['value']!r} (limit {rel} {c['limit']!r})", file=sys.stderr)
    print(json.dumps({**out["result"], "checks": checks}))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.t_start = time.perf_counter() if t_start is None else t_start
    return run(args)
