"""Readings that the limits of `correct` are set from: one cell, many
seeds, in one process (set-up is long), each seed's program or control
run set up, driven for a short window and checked as a benchmark run is.

    python3 benchmark/calibrate.py --workload train.b32 --seeds 11 12 13 \
        [--mode program|control|<fault>] [--calls N] [--out f.jsonl]

program: the system under test, sound. control: the reference in the
program's place with TF32 on (`Context.control`), the nearest precision
below the configurations' fp32 with TF32 off. The others plant a fault of
`benchmark.faults` under the timed path. Prints one JSON line a seed:
its numbers and the check's record. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path[0] = ROOT
    from benchmark import faults

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control") + tuple(faults.FAULTS))
    ap.add_argument("--calls", type=int, default=8,
                    help="serving calls after set-up (the training checks read set-up's steps)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, head
    from smirk_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    kernels.build()
    cell = harness.find(args.workload)
    device = torch.device("cuda", 0)
    bundle = head.head(full_size=True)
    fault = faults.FAULTS.get(args.mode, contextlib.nullcontext)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell.cfg, cell.traffic, cell.spec, seed, device, bundle,
                              control=args.mode == "control")
        e = harness.entry(cell, ctx)
        with fault():
            e.setup()
            if cell.traffic["entry"] != "train_step":
                for _ in range(args.calls):
                    e.call()
        e.release()
        checked = e.check()
        line = {"cell": cell.name, "seed": seed, "mode": args.mode,
                "numbers": checked["numbers"], "coverage": checked["coverage"],
                "record": checked["record"], "seconds": time.perf_counter() - t0,
                "card": harness.card()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del e
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
