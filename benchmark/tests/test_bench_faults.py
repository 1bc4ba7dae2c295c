"""A run's check with the timed path broken underneath: past the
harness's look for a card, every cell is driven on the CPU at a small
size, sound and with each fault the cell can have, and `correct` comes
out false for each fault; run.py itself prints no result without a card
or without the program."""
import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults, harness, head

FAULTS = {"train.b32": ("unchanged", "half_batch", "generator_lr"), "pretrain.b32": ("unchanged", "half_batch"),
          "infer.b64": ("half_batch", "answer")}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def small_run(cell_name, fault=None, seed=2 ** 31 + 11):
    """One run of the cell on the CPU: 64 px, batches of 4, the small
    procedural head, two seconds of window."""
    cell = harness.find(cell_name)
    cfg = json.loads(json.dumps(cell.cfg))
    cfg["image_size"] = 64
    cfg["train"]["batch_size"] = 4
    cfg["train"]["mask_dilation_radius"] = 3
    cell.cfg = cfg
    cell.traffic = dict(cell.traffic, batch=4, pool=3)
    args = argparse.Namespace(seed=seed, seconds=2.0, trace=0, t_start=time.perf_counter())
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = harness.execute(cell, args, torch.device("cpu"), head.head(full_size=False))
    return out


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in (None,) + fs])
def test_fault_fails_the_check(cell, fault):
    out = small_run(cell, fault)
    assert out["result"]["correct"] is (fault is None), out["checks"]
    # the window's calls only, not set-up's checked steps
    assert out["result"]["attempted"] == out["result"]["calls"]["count"]


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_no_result_without_a_card_or_the_program(tmp_path, only_benchmark):
    root = harness.ROOT
    if only_benchmark:
        shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
        shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        root = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "infer.b64",
                        "--seed", "4294967301", "--seconds", "1", "--trace", "0"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
