"""The program's own spans in a traced slice: the `smirk.*` ranges that
`smirk_tpu_torch.utils.profiling.span` records through torch.profiler, on
the profiler's clock, read from the slice's Chrome trace beside the kernels.

`reduce(events, calls)` gives, for each span name, the device time it
launched, its host wall, the device-idle time under it and its count, and
the host synchronisations inside the calls, each named by its span and its
aten op. Run as a script, it runs one cell as `benchmark/run.py --trace 1`
does and writes the spans of that run's traced slice:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> --out <json>
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    # the checkout's root, not this folder, whose module names would shadow
    # the standard library's (as benchmark/run.py)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import devtrace  # noqa: E402

PREFIX = "smirk."
ROOTS = ("smirk.train_step", "smirk.infer")
PHASES = ("smirk.phase1", "smirk.phase2")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Range = Tuple[float, float, str]


def _innermost(ranges: Sequence[Range], times: Sequence[float]) -> List[Optional[int]]:
    """For each time, the index of the shortest range in `ranges` (sorted
    by start) that holds it, or None: interval nesting over every range,
    on any thread."""
    out: List[Optional[int]] = [None] * len(times)
    active: List[int] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(ranges) and ranges[j][0] <= t:
            active.append(j)
            j += 1
        active = [i for i in active if ranges[i][1] >= t]
        if active:
            out[k] = min(active, key=lambda i: ranges[i][1] - ranges[i][0])
    return out


def _aten_op(ops: Sequence[dict], tid, t: float) -> Optional[dict]:
    """The shortest aten:: op on thread `tid` that holds time t."""
    inner = [o for o in ops if o["tid"] == tid and o["ts"] <= t <= o["ts"] + o["dur"]]
    return min(inner, key=lambda o: o["dur"]) if inner else None


def reduce(events: List[dict], calls: int) -> Dict:
    """-> {"calls", "names": {span: {"device_s", "host_s", "idle_s",
    "count"}}, "unattributed_busy_s", "syncs": {"count", "by": [[span,
    aten op, runtime calls, count]]}} over the slice's events.

    device_s: the summed device time of the kernels, copies and memsets
    whose launch (the runtime or driver event of the same correlation id,
    on any thread) lies in the span as the innermost `smirk.*` range;
    host_s: the summed wall of the span's ranges; idle_s: the device-idle
    gaps of the slice whose midpoint lies in the span as the innermost
    range. unattributed_busy_s: device time whose innermost range is a
    root or a phase (ROOTS, PHASES). A host sync is a `*Synchronize`
    runtime call, or a `cudaMemcpy*` whose device copy is device to host,
    inside a root range; the calls within one aten op (a copy and the
    synchronize that waits for it) are one sync."""
    slice_ = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == devtrace.SLICE]
    if not slice_:
        raise RuntimeError("the trace holds no slice span")
    t0 = float(slice_[0]["ts"])
    t1 = t0 + float(slice_[0]["dur"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIX))
    names: Dict[str, Dict[str, float]] = {}

    def entry(name):
        return names.setdefault(name, {"device_s": 0.0, "host_s": 0.0, "idle_s": 0.0,
                                       "count": 0})

    for s, e, name in ranges:
        entry(name)["host_s"] += (e - s) * 1e-6
        entry(name)["count"] += 1

    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in devtrace.DEVICE_CATS]
    linked = [(e, launches.get(e.get("args", {}).get("correlation"))) for e in device]
    linked = [(d, r) for d, r in linked if r is not None]
    unattributed = 0.0
    for (d, _), i in zip(linked, _innermost(ranges, [float(r["ts"]) for _, r in linked])):
        if i is None:
            continue
        name = ranges[i][2]
        entry(name)["device_s"] += float(d["dur"]) * 1e-6
        if name in ROOTS + PHASES:
            unattributed += float(d["dur"]) * 1e-6

    busy = devtrace._union(
        (max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
        for e in device if min(float(e["ts"]) + float(e["dur"]), t1) > max(float(e["ts"]), t0))
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    for (s, e), i in zip(gaps, _innermost(ranges, [0.5 * (s + e) for s, e in gaps])):
        if i is not None:
            entry(ranges[i][2])["idle_s"] += (e - s) * 1e-6

    copies = {e["args"]["correlation"]: e["name"] for e in device
              if e.get("cat") == "gpu_memcpy" and "correlation" in e.get("args", {})}
    roots = [r for r in ranges if r[2] in ROOTS]
    blocking = [e for e in events if e.get("cat") == "cuda_runtime" and (
        e["name"].endswith("Synchronize")
        or (e["name"].startswith("cudaMemcpy")
            and "DtoH" in copies.get(e.get("args", {}).get("correlation"), "")))]
    blocking = [e for e in blocking
                if any(s <= float(e["ts"]) <= t for s, t, _ in roots)]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    where = _innermost(ranges, [float(e["ts"]) for e in blocking])
    points: Dict[tuple, list] = {}
    for e, i in zip(blocking, where):
        op = _aten_op(ops, e.get("tid"), float(e["ts"]))
        key = ((e.get("tid"), op["ts"], op["name"]) if op is not None
               else (e.get("tid"), e["ts"], e["name"]))
        label = points.setdefault(key, [ranges[i][2] if i is not None else None,
                                        op["name"] if op is not None else None, []])
        label[2].append(e["name"])
    by: Dict[tuple, int] = {}
    for span, op, runtime in points.values():
        k = (span, op, "+".join(runtime))
        by[k] = by.get(k, 0) + 1
    return {
        "calls": calls,
        "names": names,
        "unattributed_busy_s": unattributed,
        "syncs": {"count": len(points),
                  "by": [[*k, n] for k, n in sorted(by.items(), key=lambda kv: -kv[1])]},
    }


def per_call(spans: Dict) -> Dict:
    """The reduction a call: ms and counts of each span, the syncs, and the
    share of the device time launched inside the roots that falls under a
    span other than a root or a phase."""
    n = spans["calls"]
    names = {k: {"device_ms": v["device_s"] / n * 1e3, "host_ms": v["host_s"] / n * 1e3,
                 "idle_ms": v["idle_s"] / n * 1e3, "count": v["count"] / n}
             for k, v in sorted(spans["names"].items())}
    total = sum(v["device_s"] for v in spans["names"].values())
    return {
        "names": names,
        "unattributed_busy_ms": spans["unattributed_busy_s"] / n * 1e3,
        "attributed_share": 1.0 - spans["unattributed_busy_s"] / total if total else None,
        "syncs": spans["syncs"]["count"] / n,
        "syncs_by": [[s, op, rt, c / n] for s, op, rt, c in spans["syncs"]["by"]],
    }


def span_cost_us(n: int = 100000) -> Dict[str, float]:
    """Microseconds of one enter and exit of the program's span, with no
    profiler and under the slice's profiler."""
    import torch

    from smirk_tpu_torch.utils.profiling import span

    def loop(count):
        t = time.perf_counter()
        for _ in range(count):
            with span("smirk.infer"):
                pass
        return (time.perf_counter() - t) / count * 1e6

    off = loop(n)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities):
        on = loop(n // 10)
    return {"off": off, "on": on}


def run(args) -> Dict:
    """One run of the cell as `benchmark/run.py --trace 1`, the traced
    slice's events and each of its calls' seconds kept -> the result line,
    the spans a call, the traced and untraced call p50 and the span's
    cost."""
    import torch

    from benchmark import harness, head
    from smirk_tpu_torch import kernels

    cell = harness.find(args.workload)
    kernels.build()
    kept: Dict = {}
    profile = devtrace.profile

    def keep(fn, calls):
        call_s = []

        def timed():
            t = time.perf_counter()
            fn()
            call_s.append(time.perf_counter() - t)

        events = profile(timed, calls)
        kept.update(events=events, call_s=call_s)
        return events

    devtrace.profile = keep
    try:
        out = harness.execute(cell, args, torch.device("cuda", 0), head.head(full_size=True))
    finally:
        devtrace.profile = profile
    spans = reduce(kept["events"], len(kept["call_s"]))
    return {
        "cell": cell.name, "seed": args.seed, "card": harness.card(),
        "correct": out["result"]["correct"],
        "metrics": out["result"]["metrics"], "breakdown": out["result"]["breakdown"],
        "window_p50_ms": out["result"]["calls"]["p50_ms"],
        "traced_p50_ms": harness.percentile(kept["call_s"], 50) * 1e3,
        "traced_call_ms": [s * 1e3 for s in kept["call_s"]],
        "span_cost_us": span_cost_us(),
        "spans": spans, "per_call": per_call(spans),
    }


def main(argv: Optional[List[str]] = None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="The program's spans in one traced run of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    args.trace, args.t_start = 1, t_start
    import torch

    if not torch.cuda.is_available():
        print("benchmark/spans.py: needs a CUDA card", file=sys.stderr)
        return 2
    res = run(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    pc = res["per_call"]
    print(json.dumps({"cell": res["cell"], "correct": res["correct"],
                      "window_p50_ms": res["window_p50_ms"],
                      "traced_p50_ms": res["traced_p50_ms"],
                      "attributed_share": pc["attributed_share"],
                      "unattributed_busy_ms": pc["unattributed_busy_ms"],
                      "syncs": pc["syncs"], "span_cost_us": res["span_cost_us"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
