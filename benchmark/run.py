"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See benchmark/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".benchmark_cache", sub)

if __name__ == "__main__":
    # the checkout's root, not this folder, whose module names would
    # shadow the standard library's
    sys.path[0] = ROOT
    from benchmark import harness

    sys.exit(harness.main(t_start=T_START))
