"""The port's training CLI end to end on the CPU (smirk_tpu_torch.cli.train
--device cpu --synthetic), at tiny widths (two-stage backbones, 32 px,
batch 4, generator 32 features / 5 blocks, the cycle path on) on the
procedural head, with configs/config_train.yaml plus overrides.

The synthetic stream draws its augmentation from unseeded generators; the
recovery test seeds each sample with its index, so a resumed run's first
step can be recomputed exactly: it equals, bit for bit, one step of a
system restored from the salvaged checkpoint on the same batch.
"""
import json
import os

import numpy as np
import pytest
import torch

from smirk_tpu_torch import Predictor, assets
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.cli import train as cli
from smirk_tpu_torch.config import load_config
from smirk_tpu_torch.data import datasets as PD
from smirk_tpu_torch.data import pipeline as PP
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils import checkpoint as ckpt

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
CONFIG = "configs/config_train.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overrides(log, **extra):
    out = {"image_size": 32, "arch.num_expression": 10, "arch.num_shape": 30,
           "train.batch_size": 4, "train.num_workers": 0, "train.num_epochs": 1,
           "train.save_every": 1, "train.visualize_every": 0,
           "train.log_losses_every": 1, "train.mask_dilation_radius": 3,
           "train.log_path": log, **extra}
    return [f"{k}={v}" for k, v in out.items()]


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """No asset root here: the procedural head; tiny backbones under the
    config's names; 4 synthetic training samples a step, 4 steps."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(mnv3.ARCHS, SMALL, TINY_SMALL)
    monkeypatch.setitem(mnv3.ARCHS, LARGE, TINY_LARGE)
    monkeypatch.setenv("SMIRK_SYNTH_LEN", "16")
    monkeypatch.delenv("SMIRK_FAULT_INJECT_STEP", raising=False)


def records(log):
    with open(os.path.join(log, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_artifacts_and_predictor(tmp_path):
    """One epoch: config.json, metrics.jsonl with landmark_loss_mp (train
    and val), model_0.pt, last_state.pt and train_images/*.jpg; model_0.pt
    into Predictor(device="cpu") reproduces the trained system's infer."""
    log = str(tmp_path / "logs")
    cli.main([CONFIG, "--synthetic", "--device", "cpu"]
             + overrides(log, **{"train.visualize_every": 2, "train.num_workers": 2}))
    with open(os.path.join(log, "config.json")) as f:
        assert json.load(f)["train"]["batch_size"] == 4
    recs = records(log)
    train = [r for r in recs if r["phase"] == "train"]
    assert [r["global_step"] for r in train] == [1, 2, 3, 4]
    assert any(r["phase"] == "val" for r in recs)
    assert all(np.isfinite(r["landmark_loss_mp"]) and np.isfinite(r["cycle_loss"])
               for r in train)
    imgs = sorted(os.listdir(os.path.join(log, "train_images")))
    assert imgs == ["0_0.jpg", "0_2.jpg"]
    assert os.listdir(os.path.join(log, "val_images")) == ["0_0.jpg"]

    config = load_config(CONFIG, tuple(overrides(log)))
    system = SmirkSystem(config, assets.load_all(), device="cpu")
    ckpt.restore_state(system, os.path.join(log, "last_state.pt"))
    assert system.step == 4
    pred = Predictor(checkpoint=os.path.join(log, "model_0.pt"), device="cpu",
                     bundle=assets.load_all(), config=config)
    img = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    want = system.infer(torch.from_numpy(img))
    got = pred(img)
    for k in ("expression_params", "shape_params", "vertices", "rendered_img"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)


def test_fault_salvage_and_exact_resume(tmp_path, monkeypatch):
    """A fault after step 3 salvages last_state.pt at step 3; resume_state=
    restarts the epoch at step 3 and finishes it; the resumed run's first
    step equals one step of the salvaged state on the same batch, bitwise."""
    monkeypatch.setattr(PD.FaceDataset, "__getitem__",
                        lambda self, i: self._get(i, np.random.default_rng(i)))
    log = str(tmp_path / "logs")
    args = [CONFIG, "--synthetic", "--device", "cpu"] + overrides(
        log, **{"train.ckpt_every_steps": 2})
    monkeypatch.setenv("SMIRK_FAULT_INJECT_STEP", "3")
    with pytest.raises(RuntimeError, match="SMIRK_FAULT_INJECT_STEP=3"):
        cli.main(args)
    state_path = os.path.join(log, "last_state.pt")
    assert torch.load(state_path, weights_only=True)["step"] == 3
    salvaged = str(tmp_path / "salvaged.pt")
    os.replace(state_path, salvaged)

    monkeypatch.delenv("SMIRK_FAULT_INJECT_STEP")
    cli.main(args + [f"resume_state={salvaged}"])
    resumed = [r for r in records(log) if r["phase"] == "train" and r["global_step"] > 3]
    assert [r["global_step"] for r in resumed] == [4, 5, 6, 7]
    assert torch.load(state_path, weights_only=True)["step"] == 7

    config = load_config(CONFIG, tuple(args[4:]))
    system = SmirkSystem(config, assets.load_all(), device="cpu", steps_per_epoch=4)
    ckpt.restore_state(system, salvaged)
    loader, _ = PP.load_dataloaders(config, synthetic=True)
    batch = next(iter(loader))  # the replayed epoch's first batch (seed 0's shuffle)
    metrics, _ = system.train_step(batch, parity=0)
    first = resumed[0]
    assert {k: first[k] for k in metrics} == metrics


def test_prestep_fault_keeps_previous_checkpoint(tmp_path, monkeypatch, capsys):
    """A fault before any step completes leaves an existing last_state.pt
    byte for byte as it was: there is nothing to salvage."""
    log = tmp_path / "logs"
    log.mkdir()
    sentinel = b"sentinel-previous-checkpoint"
    (log / "last_state.pt").write_bytes(sentinel)
    monkeypatch.setenv("SMIRK_FAULT_INJECT_STEP", "-1")
    with pytest.raises(RuntimeError, match="pre-step fault"):
        cli.main(["--synthetic", "--device", "cpu"] + overrides(str(log)))
    assert "no completed step to salvage" in capsys.readouterr().err
    assert (log / "last_state.pt").read_bytes() == sentinel
