"""Profiling and debugging (port of smirk_tpu/utils/profiling.py).

  * `trace(logdir)`: a `torch.profiler.profile` context over the CPU and,
    when there is one, the CUDA card, exporting a Chrome trace
    (`logdir/trace.json`, viewable in Perfetto) on exit;
  * `Timer`: the median wall time of a callable, each call ended by
    `torch.cuda.synchronize()` when the card is in use;
  * `enable_nan_debugging()`: autograd's anomaly detection, which names
    the forward operation of a backward that produced NaN.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Median wall time in seconds of `fn(*args)`, warm-up calls excluded."""

    def __init__(self, fn: Callable, warmup: int = 1, iters: int = 10):
        self.fn, self.warmup, self.iters = fn, warmup, iters

    def __call__(self, *args, **kwargs) -> float:
        for _ in range(self.warmup):
            self.fn(*args, **kwargs)
        _sync()
        times = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            self.fn(*args, **kwargs)
            _sync()
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
