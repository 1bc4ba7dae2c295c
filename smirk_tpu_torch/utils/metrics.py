"""Structured metric logging: a jsonl file + the console (a copy of
smirk_tpu/utils/metrics.py).

One record per log call in an append-only `metrics.jsonl`, plus the
reference's console line, keeping losses greppable and plottable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, every: int = 10):
        self.every = max(1, every)
        self.fh = None
        if log_path:
            os.makedirs(log_path, exist_ok=True)
            self.fh = open(os.path.join(log_path, "metrics.jsonl"), "a")
        self.t0 = time.time()

    def log(self, step: int, metrics: Dict, phase: str = "train",
            force: bool = False, epoch: Optional[int] = None,
            global_step: Optional[int] = None) -> None:
        if step % self.every and not force:
            return
        rec = {
            "step": int(step),  # per-epoch batch index (reference convention)
            "phase": phase,
            "t": round(time.time() - self.t0, 3),
        }
        if epoch is not None:  # disambiguate records across epochs/phases
            rec["epoch"] = int(epoch)
        if global_step is not None:
            rec["global_step"] = int(global_step)
        rec.update({k: float(v) for k, v in metrics.items()})
        if self.fh:
            self.fh.write(json.dumps(rec) + "\n")
            self.fh.flush()
        line = " ".join(f"{k}: {float(v):.6f}" for k, v in metrics.items())
        print(f"[{phase} {step}] {line}")

    def close(self):
        if self.fh:
            self.fh.close()
