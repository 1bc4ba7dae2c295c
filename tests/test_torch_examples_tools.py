"""The port's examples and tools on the CPU: `smirk_tpu_torch.examples`
(predict, expression_edit, reconstruct, as tests/test_examples.py drives
examples/), `cli.check_parity` (as tests/test_check_parity_harness.py
drives tools/check_parity.py, on a fixture made from the JAX package's
outputs for the same weights) and `cli.train_supervisor` (as
tests/test_fault_tolerance.py drives tools/train_supervisor.py).

No asset root here: the port's (and, for the fixture, the JAX package's)
FLAME bundle is the procedural head, and the backbones are tiny tables
under the config's names. check_parity's gate: every RMSE < 1e-3.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu.utils import importer
from smirk_tpu_torch import assets
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.cli import check_parity
from smirk_tpu_torch.cli.train_supervisor import supervise
from smirk_tpu_torch.examples import expression_edit, predict, reconstruct
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.models.encoders import SmirkEncoder
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CLI_RUNNER = f"""
import sys
import torch
torch.set_num_threads(1)
from smirk_tpu_torch import assets
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.models import mobilenetv3 as mnv3
mnv3.ARCHS["{SMALL}"] = {TINY_SMALL!r}
mnv3.ARCHS["{LARGE}"] = {TINY_LARGE!r}
assets.load_all = lambda *a, **k: procedural_bundle(seed=0, full_size=False)
from smirk_tpu_torch.cli import train
train.main(sys.argv[1:])
"""


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(mnv3.ARCHS, SMALL, TINY_SMALL)
    monkeypatch.setitem(mnv3.ARCHS, LARGE, TINY_LARGE)


def face_png(path, seed=0, size=(140, 120)):
    img = (np.random.default_rng(seed).random((size[1], size[0], 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def test_predict_and_expression_edit_examples(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        face_png(d / f"im{i}.png", seed=i)
    out = tmp_path / "out"
    predict.main(["--images", str(d), "--out", str(out), "--batch", "2", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["panel_im0.png", "panel_im1.png", "panel_im2.png",
                                       "params.npz"]
    z = np.load(out / "params.npz")
    assert z["codes"].shape == (3, 50 + 3 + 3) and np.isfinite(z["codes"]).all()

    edit = tmp_path / "edit.png"
    expression_edit.main(["--image", str(d / "im0.png"), "--amplify", "3.0",
                          "--jaw_open", "0.2", "--out", str(edit), "--device", "cpu"])
    panel = np.asarray(Image.open(edit))
    assert panel.shape[1] == 3 * panel.shape[0]  # [input | recon | edited]


def test_reconstruct_example(tmp_path):
    img = tmp_path / "face.png"
    face_png(img, seed=11, size=(200, 180))
    theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
    lmk = np.stack([100 + 40 * np.cos(theta), 90 + 50 * np.sin(theta)], 1).astype(np.float32)
    np.save(tmp_path / "lmk.npy", lmk)
    out = tmp_path / "recon.png"
    reconstruct.main(["--image", str(img), "--landmarks", str(tmp_path / "lmk.npy"),
                      "--out", str(out), "--device", "cpu"])
    panel = np.asarray(Image.open(out))
    assert panel.shape[1] == 4 * panel.shape[0] and panel.std() > 0  # 4 columns


@pytest.fixture(scope="module")
def parity_files(tmp_path_factory):
    """A reference-layout checkpoint (`smirk_encoder.*`, seeded weights at
    the default widths on the tiny tables) and a fixture of the JAX
    package's encoder -> FLAME outputs for it on a seeded image, its
    landmarks raw 3-D as the reference emits them."""
    d = tmp_path_factory.mktemp("parity")
    enc = SmirkEncoder(n_exp=50, n_shape=300, pose_stages=TINY_SMALL,
                       shape_stages=TINY_LARGE, expression_stages=TINY_LARGE)
    enc.init_weights(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    sd = {f"smirk_encoder.{k}": v + (0.02 * torch.randn(v.shape, generator=g)
                                     if v.dtype.is_floating_point else 0)
          for k, v in enc.state_dict().items()}
    ckpt = str(d / "SMIRK_test.pt")
    torch.save(sd, ckpt)

    mp = pytest.MonkeyPatch()
    mp.setitem(jax_mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(jax_mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    try:
        system = JaxSmirkSystem(JaxConfig(), procedural_bundle(seed=0, full_size=False),
                                steps_per_epoch=1, use_pallas=False)
        variables = system.encoder.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
        enc_sd, _ = importer.split_smirk_checkpoint(
            {k: v.numpy() for k, v in sd.items()})
        variables = importer.import_state_dict(enc_sd, variables)
        img = np.random.default_rng(3).random((1, 224, 224, 3), np.float32)
        enc_out = system.encoder.apply(variables, jnp.asarray(img), train=False)
        flame_out = system.flame(enc_out)
    finally:
        mp.undo()
    fixture = {"img": img, **{k: np.asarray(enc_out[k]) for k in (
        "expression_params", "pose_params", "cam", "shape_params")},
        "vertices": np.asarray(flame_out["vertices"]),
        "landmarks_mp": np.asarray(flame_out["landmarks_mp"])}
    assert fixture["landmarks_mp"].shape[-1] == 3
    return ckpt, fixture, d


def test_check_parity_passes_on_the_jax_package_outputs(parity_files, capsys):
    ckpt, fixture, d = parity_files
    path = str(d / "ref.npz")
    np.savez(path, **fixture)
    rc = check_parity.main(["--checkpoint", ckpt, "--ref_fixture", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "using the fixture's stored input image" in out and "vertex_rmse" in out, out
    assert "PARITY PASS" in out and rc == 0, out


def test_check_parity_fails_on_perturbed_vertices(parity_files, capsys):
    ckpt, fixture, d = parity_files
    path = str(d / "bad.npz")
    np.savez(path, **dict(fixture, vertices=fixture["vertices"] + 0.01))
    rc = check_parity.main(["--checkpoint", ckpt, "--ref_fixture", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "PARITY FAIL" in out and rc == 1, out


def test_supervisor_relaunches_after_a_fault_and_resumes(tmp_path, capfd):
    """The first child faults after step 3 (SMIRK_FAULT_INJECT_STEP=3),
    salvaging last_state.pt at step 3; the supervisor relaunches with
    resume_state=<log>/last_state.pt and the second child replays the
    epoch from there to step 3 + 4."""
    log = str(tmp_path / "logs")
    args = ["--synthetic", "--device", "cpu", "image_size=32", "arch.num_expression=10",
            "arch.num_shape=30", "train.batch_size=4", "train.num_workers=0",
            "train.num_epochs=1", "train.save_every=10", "train.visualize_every=0",
            "train.log_losses_every=1", "train.mask_dilation_radius=3",
            "train.ckpt_every_steps=1", f"train.log_path={log}"]
    env = dict(os.environ, SMIRK_FAULT_INJECT_STEP="3", SMIRK_SYNTH_LEN="16",
               PYTHONPATH=REPO)
    rc = supervise([sys.executable, "-c", _CLI_RUNNER] + args, log, max_restarts=2,
                   backoff=0.1, env=env)
    out = capfd.readouterr()
    assert rc == 0, out.out[-3000:] + out.err[-3000:]
    assert "SMIRK_FAULT_INJECT_STEP=3" in out.err
    assert f"resume_state={log}/last_state.pt" in out.out
    assert "[resume]" in out.out and "step=3" in out.out
    assert torch.load(os.path.join(log, "last_state.pt"), weights_only=True)["step"] == 7
    with open(os.path.join(log, "metrics.jsonl")) as f:
        steps = [json.loads(line)["global_step"] for line in f
                 if json.loads(line)["phase"] == "train"]
    assert steps == [1, 2, 4, 5, 6, 7]  # the fault fires before step 3 is logged


def test_supervisor_probe_and_user_resume(tmp_path, capfd):
    """The device probe is a subprocess matmul on the card (it fails here,
    without one, and the supervisor gives up at launch); a user's
    resume_state= is kept and no second one is appended."""
    assert supervise([sys.executable, "-c", "pass"], str(tmp_path), probe=False) == 0
    from smirk_tpu_torch.cli import train_supervisor as ts

    r = subprocess.run([sys.executable, "-c", ts._PROBE], capture_output=True)
    assert (r.returncode == 0) == torch.cuda.is_available()
    open(tmp_path / "last_state.pt", "wb").close()
    echo = "import sys; print('ARGS', sys.argv[1:])"
    assert supervise([sys.executable, "-c", echo, "resume_state=mine.pt"],
                     str(tmp_path)) == 0
    assert "ARGS ['resume_state=mine.pt']" in capfd.readouterr().out
    assert supervise([sys.executable, "-c", echo], str(tmp_path)) == 0
    assert f"resume_state={tmp_path}/last_state.pt" in capfd.readouterr().out
