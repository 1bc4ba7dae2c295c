"""The traced slice: a few calls under torch.profiler (CPU and CUDA), its
Chrome trace read back, and the device's busy time, kernel time by class,
the longest kernels and the idle gaps by what the host was doing.

`KERNEL_CLASSES` is chip_smoke.py's, at commit 19e99aba3b04: kernel-name
fragments -> class, the first match wins.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List

import torch

KERNEL_CLASSES = (
    ("port kernels K1, K3-K11", ("raster_fused", "raster_planes",
                             "segment_moments", "fold_faces", "raster_coverage",
                             "segment_reduce", "raster_bins", "raster_groups",
                             "raster_chunkskip")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft",
                     "wgrad", "dgrad", "nchw", "nhwc")),
    ("matmul", ("gemm", "cutlass", "ampere", "sm90")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce", "welford", "var_mean", "norm")),
    ("scatter / gather / index", ("scatter", "gather", "index", "topk", "sort",
                                  "radix", "cumsum", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill",
                     "where", "clamp", "pool")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SLICE = "benchmark_slice"
TOP = 10
NAME_CHARS = 120


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")


def profile(fn: Callable[[], None], calls: int) -> List[dict]:
    """`calls` calls of fn (each ends in a synchronize) under the profiler
    -> the trace's complete events."""
    from torch.profiler import ProfilerActivity, record_function

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with record_function(SLICE):
                for _ in range(calls):
                    fn()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: List[dict], calls: int) -> Dict:
    """-> {"window_s", "busy_s", "calls", "class_s": {class: s}, "kernel_s":
    {name: s}, "device_ops": [[name, s]], "idle_gaps": [[host op, s]]},
    the device's time within the slice's own span."""
    span = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == SLICE]
    if not span:
        raise RuntimeError("the trace holds no slice span")
    t0, t1 = float(span[0]["ts"]), float(span[0]["ts"]) + float(span[0]["dur"])
    dev = []
    class_s, kernel_s = {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), t0)
        end = min(float(e["ts"]) + float(e["dur"]), t1)
        if end <= s:
            continue
        dev.append((s, end))
        if e["cat"] == "kernel":
            sec = (end - s) * 1e-6
            name = e["name"][:NAME_CHARS]
            kernel_s[name] = kernel_s.get(name, 0.0) + sec
            cls = kernel_class(e["name"])
            class_s[cls] = class_s.get(cls, 0.0) + sec
    busy = _union(dev)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in HOST_CATS and e["name"] != SLICE)
    starts = [h[0] for h in host]
    idle = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        inner = [h for h in host[max(0, i - 4000):i] if h[1] >= mid]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host op"
        idle[label[:NAME_CHARS]] = idle.get(label[:NAME_CHARS], 0.0) + (e - s) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "calls": calls,
        "class_s": class_s,
        "kernel_s": kernel_s,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
