"""The port's data-parallel step over torch.distributed (smirk_tpu_torch.
parallel) against its one-process step, on the CPU with gloo.

Two ranks, each on its half of a global batch of 4, against one process on
all 4, at tests/multihost_worker.py's tiny system (32 px, 10 / 30
components, generator 8 / 1, no teachers), both parities
(tests/torch_parallel_worker.py runs every process with one torch thread,
MASTER_ADDR 127.0.0.1 on a free port). The cases: "base" (one row without
FAN labels), "denom" (FAN labels only in rank 1's rows: the masked
landmark loss's denominator is the global count), "augment" (Ke = 2, the
cycle path's augmentation permuting rows across the ranks) at learning
rate 0, and "step" at the default rate.

What the comparison leaves out, and why (the worker's docstring has the
detail): the discrete parts of a step (the masked images' hint pixels and
holes, the cycle path's render of the augmented parameters) come from the
reference, after each rank's own are checked equal to the reference's
rows; and the reference's train-mode batch norm normalizes by the moments
of its rows as the ranks hold them (each part's two-pass moments, combined
by the parallel-variance formula). At this size a channel whose variance is
a small fraction of its mean square makes the generator's gradients move
by ~1e-3 of a tensor's magnitude between two exact formulas of the same
statistics (torch's batch norm against two-pass moments, or those against
the ranks' combination), and by ~1 % on torch's one-thread CPU batch norm
against a float64 run. `test_two_ranks_match_one_process_both_parities`
holds the ranks' statistics and their gradient to torch's one-process
batch norm on their own.

Tolerances: every metric within 1e-4 x max(1, |reference|) (the JAX
worker's bound); each summed gradient within 1e-4 of its tensor's max
magnitude, or of 1 % of its `_grads` call's largest entry where that is
more (a backward's rounding is of the call's scale: a batch-norm bias that
a 1x1 convolution and another batch norm cancel has an exact gradient of
0, and its reference's entries, ~1e-8 of the call's largest, are rounding
alone); the batch-norm running statistics within 1e-5; the discrete parts
equal. The two ranks' parameters and statistics are bitwise
equal after every step.

Also: `dryrun_multichip(2)` prints ok, and the training CLI under two gloo
ranks (`--synthetic --device cpu`, 2 steps): only rank 0 logs and writes
last_state.pt / model_0.pt, and every rank's state after a resume from it
(the restore, then `parallel.replicate`) equals the saved state.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
METRIC_RTOL, GRAD_RTOL, STATS_ATOL = 1e-4, 1e-4, 1e-5
GRAD_FLOOR = 1e-2  # of the call's largest entry, the least scale a tensor is held at

_CLI_RUNNER = """
import os, sys
import torch
torch.set_num_threads(1)
from smirk_tpu_torch import assets, parallel
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.utils import checkpoint as ckpt
mnv3.ARCHS["tf_mobilenetv3_small_minimal_100"] = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)],
                                                  [("cn", 0, 40, 1)]]
mnv3.ARCHS["tf_mobilenetv3_large_minimal_100"] = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)],
                                                  [("cn", 0, 48, 1)]]
assets.load_all = lambda *a, **k: procedural_bundle(seed=0, full_size=False)
rank = os.environ["RANK"]
save_state = ckpt.save_state

def noted(name, fn):
    def run(*a, **k):
        with open(os.environ["SIDE"], "a") as f:
            f.write(f"{rank} {name}\\n")
        return fn(*a, **k)
    return run

ckpt.save_state = noted("save_state", save_state)
ckpt.save_model = noted("save_model", ckpt.save_model)
replicate = parallel.replicate

def dumped(system):
    replicate(system)
    save_state(system, os.environ["DUMP"] + rank)

parallel.replicate = dumped
from smirk_tpu_torch.cli import train
train.main(sys.argv[1:])
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(cmds, env=None, timeout=600):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=e) for c, e in zip(cmds, env or [None] * len(cmds))]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"r0", "r1", "ref"} -> the worker's results: the two ranks and the
    one-process reference (run first: the ranks read its discrete parts)."""
    d = tmp_path_factory.mktemp("parallel")
    held = str(d / "held.pt")
    run_all([[sys.executable, WORKER, "-1", "2", "0", str(d / "ref.pt"), held]])
    port = str(free_port())
    run_all([[sys.executable, WORKER, str(r), "2", port, str(d / f"r{r}.pt"), held]
             for r in (0, 1)])
    return {k: torch.load(d / f"{k}.pt", weights_only=False) for k in ("r0", "r1", "ref")}


def check_case(runs, key):
    got, ref = runs["r0"][key], runs["ref"][key]
    assert got["flips"] and not any(got["flips"]), (key, got["flips"])
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= METRIC_RTOL * max(1.0, abs(want)), (key, k)
    assert len(got["grads"]) == len(ref["grads"])
    for c, (gc, rc) in enumerate(zip(got["grads"], ref["grads"])):
        top = max(float(r.abs().max()) for r in rc)
        for i, (g, r) in enumerate(zip(gc, rc)):
            scale = max(float(r.abs().max()), GRAD_FLOOR * top)
            assert float((g - r).abs().max()) <= GRAD_RTOL * scale, (key, c, i, tuple(r.shape))
    for k, r in ref["stats"].items():
        assert float((got["stats"][k] - r).abs().max()) <= STATS_ATOL, (key, k)


def test_two_ranks_match_one_process_both_parities(runs):
    for parity in (0, 1):
        check_case(runs, f"base/p{parity}")
        assert "cycle_loss" in runs["r0"][f"base/p{parity}"]["metrics"]
    # the ranks' batch-norm statistics alone (`parallel.global_moments`)
    # against torch's one-process batch norm: forward within 1e-5, the
    # input gradient (through the statistics of every rank's rows) within
    # 1e-4 of its max magnitude
    b = runs["ref"]["moments"]["y"].shape[0] // 2
    for r, got in enumerate((runs["r0"]["moments"], runs["r1"]["moments"])):
        want = {k: v[r * b:(r + 1) * b] for k, v in runs["ref"]["moments"].items()}
        assert float((got["y"] - want["y"]).abs().max()) <= 1e-5, r
        assert float((got["dx"] - want["dx"]).abs().max()) <= (
            GRAD_RTOL * float(want["dx"].abs().max())), r


def test_masked_landmark_loss_counts_the_global_batch(runs):
    """FAN labels only in rank 1's rows: rank 0 contributes 0 and rank 1
    divides by the global count (2), not by W times it."""
    check_case(runs, "denom/p0")
    assert runs["r0"]["denom/p0"]["metrics"]["landmark_loss_fan"] > 0


def test_cycle_augmentation_across_ranks(runs):
    for parity in (0, 1):
        check_case(runs, f"augment/p{parity}")


def test_ranks_bitwise_equal_after_each_step(runs):
    """The ranks' parameters and statistics after every case's step, and
    after two steps at the default learning rate; those moved the
    parameters."""
    for key, r0 in runs["r0"].items():
        if key == "moments":
            continue
        r1 = runs["r1"][key]
        assert r0["metrics"] == r1["metrics"], key
        for part in ("params", "stats"):
            for k, v in r0[part].items():
                assert torch.equal(v, r1[part][k]), (key, k)
    moved = [k for k, v in runs["r0"]["step/p1"]["params"].items()
             if not torch.equal(v, runs["r0"]["base/p0"]["params"][k])]
    assert moved


def test_dryrun_multichip_two_ranks():
    out, = run_all([[sys.executable, "-m", "smirk_tpu_torch.parallel.dryrun", "2"]])
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip(2) ok:")]
    assert line and "p1/loss_second_path" in line[0], out[-2000:]


def test_cli_two_ranks_rank0_writes_and_every_rank_restores(tmp_path):
    log = str(tmp_path / "logs")
    args = ["--synthetic", "--device", "cpu", "image_size=32", "arch.num_expression=10",
            "arch.num_shape=30", "train.batch_size=4", "train.num_workers=0",
            "train.num_epochs=1", "train.save_every=1", "train.visualize_every=0",
            "train.log_losses_every=1", "train.mask_dilation_radius=3",
            "train.ckpt_every_steps=1", f"train.log_path={log}"]

    def launch(extra, side, dump):
        port = str(free_port())
        envs = [dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port, SMIRK_SYNTH_LEN="8",
                     SIDE=side, DUMP=dump, PYTHONPATH=REPO) for r in (0, 1)]
        for e in envs:
            e.pop("SMIRK_FAULT_INJECT_STEP", None)
        run_all([[sys.executable, "-c", _CLI_RUNNER] + args + extra] * 2, envs)

    side = str(tmp_path / "writes.txt")
    launch([], side, str(tmp_path / "first"))
    with open(side) as f:
        writers = f.read().split()
    assert set(writers[::2]) == {"0"} and "save_model" in writers, writers
    with open(os.path.join(log, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["global_step"] for r in recs if r["phase"] == "train"] == [1, 2]
    state_path = os.path.join(log, "last_state.pt")
    saved = torch.load(state_path, weights_only=True)
    assert saved["step"] == 2

    # resume: the epoch is done, so every rank restores and stops
    dump = str(tmp_path / "restored")
    launch([f"resume_state={state_path}"], str(tmp_path / "writes2.txt"), dump)
    for r in (0, 1):
        got = torch.load(dump + str(r), weights_only=True)
        assert got["step"] == saved["step"]
        for name in ("encoder", "generator", "base_encoder"):
            for k, v in saved[name].items():
                assert torch.equal(got[name][k], v), (r, name, k)
        for name in ("enc_opt", "gen_opt"):
            for i, st in saved[name]["state"].items():
                for k, v in st.items():
                    assert torch.equal(got[name]["state"][i][k], v), (r, name, i, k)
