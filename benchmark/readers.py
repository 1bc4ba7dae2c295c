"""What the per-layer metrics read from a traced run's record.

The record holds the untraced window (`window`: every call's seconds, the
images done, the wall and the calling thread's CPU seconds), the traced
slice that follows it (`slice`: its wall, the device's busy
seconds, kernel seconds by class, over `calls` calls), and the check's
counts: `flops_per_call` (model FLOPs of a call on the reference) and
`raster_bound_s_per_call` (the least time of a call's raster work).
Each reader returns None where the record holds nothing to read.
"""
from __future__ import annotations

from typing import Dict, Optional

from benchmark.roofline import PEAK_FP32_FLOPS

PORT_KERNELS = "port kernels K1, K3-K11"


def idle_pct(rec: Dict) -> Optional[float]:
    s = rec.get("slice")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu_pct(rec: Dict) -> Optional[float]:
    w = rec["window"]
    if not rec.get("flops_per_call") or not w["call_s"]:
        return None
    call_s = sum(w["call_s"]) / len(w["call_s"])
    return 100.0 * rec["flops_per_call"] / call_s / PEAK_FP32_FLOPS


def class_ms(rec: Dict, cls: str) -> Optional[float]:
    s = rec.get("slice")
    if not s or cls not in s["class_s"]:
        return None
    return s["class_s"][cls] / s["calls"] * 1e3


def raster_roofline_pct(rec: Dict) -> Optional[float]:
    kernel_ms = class_ms(rec, PORT_KERNELS)
    if not kernel_ms or not rec.get("raster_bound_s_per_call"):
        return None
    return 100.0 * rec["raster_bound_s_per_call"] * 1e3 / kernel_ms


def host_cpu_ms(rec: Dict) -> Optional[float]:
    w = rec["window"]
    return w["thread_s"] / len(w["call_s"]) * 1e3 if w["call_s"] else None
