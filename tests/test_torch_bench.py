"""The port's fp32 pin (device.fp32_math around every SmirkSystem entry
point) and its bench line (python -m smirk_tpu_torch.bench) on the CPU.

The pin is read where the work runs: forward pre-hooks on the encoder and
the generator, and a wrapper of the masking the reconstruct path runs,
record both TF32 flags while the process's globals are set True. The bench
runs its three workloads at tiny shapes with `--device cpu` (plumbing only:
no number from it is a device metric).
"""
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from smirk_tpu_torch import Predictor
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.bench import FIELDS, WORKLOADS
from smirk_tpu_torch.cli.demo_video import generator_fn
from smirk_tpu_torch.config import ArchConfig, Config, TrainConfig
from smirk_tpu_torch.device import fp32_math
from smirk_tpu_torch.train import trainer
from smirk_tpu_torch.train.trainer import SmirkSystem
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
STAGES = {"tf_mobilenetv3_small_minimal_100": TINY_SMALL,
          "tf_mobilenetv3_large_minimal_100": TINY_LARGE}
S, B = 32, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both global TF32 flags True for the test, restored after it."""
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_entry_points_pin_fp32(tf32_on, monkeypatch):
    """Inside infer, train_step, eval_step, masked_input, reconstruct and
    make_visualizations, `Predictor.encode` and `render_params`, and the
    video demo's generator branch both flags read False, whatever the
    globals say; after each call, a raised one too, they read True again.
    Pins that overlap across threads restore the flags only when the last
    one exits. A Predictor's system keeps no base encoder."""
    cfg = Config(image_size=S, arch=ArchConfig(num_expression=10, num_shape=30),
                 train=TrainConfig(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3))
    bundle = procedural_bundle(seed=1, full_size=False)
    system = SmirkSystem(cfg, bundle, device="cpu",
                         backbone_stages=STAGES, generator_features=8, generator_res_blocks=1)
    pred = Predictor(device="cpu", bundle=bundle, config=cfg, backbone_stages=STAGES)
    assert pred.system.base_encoder is None and system.base_encoder is not None
    seen = []
    for m in (system.encoder, system.generator, pred.system.encoder):
        m.register_forward_pre_hook(lambda mod, args: seen.append(flags()))
    flame = pred.system.flame
    monkeypatch.setattr(pred.system, "flame",
                        lambda *a, **k: (seen.append(flags()), flame(*a, **k))[1])
    compose = trainer.masking_lib.compose_mask
    monkeypatch.setattr(trainer.masking_lib, "compose_mask",
                        lambda *a, **k: (seen.append(flags()), compose(*a, **k))[1])
    rng = np.random.default_rng(0)
    batch = {"img": rng.random((B, S, S, 3), np.float32),
             "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
             "flag_landmarks_fan": np.ones(B, bool),
             "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
             "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)}
    img = torch.from_numpy(batch["img"])
    hull = torch.ones((B, S, S, 1))
    calls = {
        "infer": lambda: system.infer(img),
        "train_step": lambda: system.train_step(batch, parity=1),
        "eval_step": lambda: system.eval_step(batch),
        "masked_input": lambda: system.masked_input(system.infer(img), img, hull),
        "reconstruct": lambda: system.reconstruct(system.infer(img), img, hull),
        "make_visualizations": lambda: system.make_visualizations(
            batch, system.train_step(batch, parity=0)[1]),
        "Predictor.encode": lambda: pred.encode(batch["img"]),
        "Predictor.render_params": lambda: pred.render_params(pred.encode(batch["img"])),
        "demo_video.generator_fn": lambda: generator_fn(system)(
            img, system.infer(img), hull, 0),
    }
    for name, call in calls.items():
        seen.clear()
        call()
        assert seen and all(f == (False, False) for f in seen), name
        assert flags() == (True, True), name
    with pytest.raises(RuntimeError):
        system.infer(torch.zeros((B, S, S, 5)))  # the stem takes 3 channels
    assert flags() == (True, True)
    with fp32_math():
        assert flags() == (False, False)
        with fp32_math():
            pass
        assert flags() == (False, False)
    assert flags() == (True, True)

    entered, release, inside = threading.Event(), threading.Event(), []

    def other():
        with fp32_math():
            entered.set()
            release.wait(30)
            inside.append(flags())

    thread = threading.Thread(target=other)
    with fp32_math():
        thread.start()
        entered.wait(30)  # exits below while the other thread is still inside
    assert flags() == (False, False)
    release.set()
    thread.join(30)
    assert inside == [(False, False)] and flags() == (True, True)


def run_bench(env_extra, *args):
    # two OpenMP threads a child: with a thread per core, the children's
    # spin-waits slow them 5-10x when the suite's other workers share the cores
    env = dict(os.environ, OMP_NUM_THREADS="2", **env_extra)
    env.pop("SMIRK_ASSETS", None)
    proc = subprocess.run([sys.executable, "-m", "smirk_tpu_torch.bench", "--device", "cpu",
                           *args], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, lines


def test_bench_line_on_cpu():
    """A provisional line first, then a final line with every field present
    and finite, tf32 false; the fields include bench.py's bf16 ones (the
    train step with arch.bf16_compute per parity, the bf16 reconstruct).
    The training options' child (`--inner train_options`, outside the
    line) times the fp32, bf16_cycle_frozen and remat_cycle steps."""
    assert {"train_ms_batch32_bf16_p0", "train_ms_batch32_bf16_p1",
            "train_ms_batch32_bf16_avg"} <= set(FIELDS["train"])
    assert {"reconstruct_bf16_fps", "reconstruct_bf16_ms_batch"} <= set(FIELDS["reconstruct"])
    rc, lines = run_bench({"SMIRK_BENCH_DEADLINE_S": "600"})
    assert rc == 0 and len(lines) == 2
    assert lines[0]["provisional"] is True and lines[0]["infer_fps_b64"] is None
    final = lines[-1]
    assert final["provisional"] is False and final["tf32"] is False
    for name in WORKLOADS:
        for f in FIELDS[name]:
            assert isinstance(final[f], float) and math.isfinite(final[f]), f
    assert final["device_name"] == "cpu" and not any(k.endswith("error") for k in final)
    assert final["infer_coverage"] > 0.05

    rc, lines = run_bench({}, "--inner", "train_options")
    assert rc == 0 and len(lines) == 1
    for name in ("fp32", "cycle_frozen", "remat"):
        for parity in (0, 1):
            for f in (f"train_ms_batch32_{name}_p{parity}", f"train_host_ms_{name}_p{parity}"):
                assert isinstance(lines[0][f], float) and math.isfinite(lines[0][f]), f
            assert lines[0][f"peak_mb_{name}_p{parity}"] is None  # the card's only


def test_bench_deadline_gives_error_fields():
    """When the children outlive a tiny deadline the final line still comes,
    its measurements null with an error field each, and the exit code is 1."""
    rc, lines = run_bench({"SMIRK_BENCH_DEADLINE_S": "3"})
    assert rc == 1 and lines[0]["provisional"] is True
    final = lines[-1]
    assert final["provisional"] is False
    for name in WORKLOADS:
        assert final[f"{name}_error"], name
        assert all(final[f] is None for f in FIELDS[name])
