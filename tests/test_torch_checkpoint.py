"""PyTorch port: checkpoints (smirk_tpu_torch.utils.checkpoint) and the
backbone init (utils.weights), against the JAX package where it writes the
file or does the same job.

The resume is held bitwise on the CPU: save after N steps, restore into a
fresh system, M more steps equal an uninterrupted N + M run exactly
(parameters, batch-norm statistics, both Adams' moments, every metric), since
a step's draws come from a generator seeded with the step counter. The JAX
package's `.npz` model export, loaded by `load_model`, gives the JAX
`infer`'s outputs at tests/test_torch_infer.py's tolerances (parameters and
geometry 1e-4; pix_to_face on >= 99.5 % of pixels, the render within 1e-4
where it agrees). The backbone init equals the JAX package's on the same
state dict exactly (a copy of the same float32 values).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu.train.trainer import TrainState
from smirk_tpu.utils import checkpoint as jax_ckpt
from smirk_tpu.utils import importer as jax_importer
from smirk_tpu_torch import Predictor
from smirk_tpu_torch.api import load_checkpoint
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils import checkpoint as ckpt
from smirk_tpu_torch.utils import weights
from smirk_tpu_torch.utils.weights import encoder_state_dict_from_jax
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B = 32, 2
ARCH = dict(num_expression=10, num_shape=30)
WEIGHTS = dict(perceptual_vgg_loss=0.0, emotion_loss=0.0, mica_loss=0.0)


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=5, full_size=False)


def port_system(bundle, generator=True, **arch):
    cfg = Config(image_size=S, arch=ArchConfig(**dict(ARCH, enable_fuse_generator=generator,
                                                      **arch)),
                 train=TrainConfig(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3,
                                   loss_weights=LossWeights(**WEIGHTS)))
    return SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES,
                       steps_per_epoch=3, generator_features=8, generator_res_blocks=1)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.ones(B, bool),
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
    }


def full_state(system):
    out = {f"encoder/{k}": v for k, v in system.encoder.state_dict().items()}
    out.update({f"generator/{k}": v for k, v in system.generator.state_dict().items()})
    for name in ("enc_opt", "gen_opt"):
        for i, st in getattr(system, name).state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": v for k, v in st.items()})
    return out


def test_resume_is_bitwise(bundle, tmp_path):
    """N steps, save, restore into a fresh system, M steps == N + M steps
    uninterrupted, bit for bit; the epoch's cosine restart falls inside."""
    batch, N, M = make_batch(0), 2, 3
    ref = port_system(bundle)
    ref_metrics = [ref.train_step(batch, parity=i)[0] for i in range(N + M)]

    first = port_system(bundle)
    for i in range(N):
        first.train_step(batch, parity=i)
    path = str(tmp_path / "state.pt")
    ckpt.save_state(first, path)
    resumed = port_system(bundle)
    ckpt.restore_state(resumed, path)
    assert resumed.step == N
    metrics = [resumed.train_step(batch, parity=i)[0] for i in range(N, N + M)]

    assert metrics == ref_metrics[N:]
    want, got = full_state(ref), full_state(resumed)
    assert set(got) == set(want) and any("exp_avg_sq" in k for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in ref.base_encoder.state_dict().items():
        assert torch.equal(resumed.base_encoder.state_dict()[k], v), k
    assert resumed.step == ref.step == N + M


def test_restore_errors(bundle, tmp_path):
    """A missing entry raises KeyError and a shape that differs ValueError,
    each naming the entry, before anything is loaded; a directory (the JAX
    package's orbax layout) and a JAX full-state .npz raise."""
    system = port_system(bundle)
    system.train_step(make_batch(1), parity=0)
    path = str(tmp_path / "state.pt")
    ckpt.save_state(system, path)

    saved = torch.load(path, weights_only=True)
    key = next(iter(saved["encoder"]))
    del saved["encoder"][key]
    torch.save(saved, str(tmp_path / "missing.pt"))
    fresh = port_system(bundle)
    before = {k: v.clone() for k, v in fresh.encoder.state_dict().items()}
    with pytest.raises(KeyError, match=f"encoder/{key}"):
        ckpt.restore_state(fresh, str(tmp_path / "missing.pt"))
    saved = torch.load(path, weights_only=True)
    del saved["gen_opt"]
    torch.save(saved, str(tmp_path / "no_opt.pt"))
    with pytest.raises(KeyError, match="gen_opt"):
        ckpt.restore_state(fresh, str(tmp_path / "no_opt.pt"))
    assert all(torch.equal(v, before[k]) for k, v in fresh.encoder.state_dict().items())
    assert fresh.step == 0

    other = port_system(bundle, num_expression=12)
    with pytest.raises(ValueError, match="shape mismatch for encoder/expression_encoder"):
        ckpt.restore_state(other, path)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_state(fresh, str(tmp_path))
    with pytest.raises(ValueError, match="orbax"):
        ckpt.save_state(fresh, str(tmp_path))
    with pytest.raises(ValueError, match="full-state"):
        ckpt.restore_state(fresh, str(tmp_path / "last_state.npz"))


def test_save_model_read_back(bundle, tmp_path):
    """save_model writes the reference layout: api.load_checkpoint reads it
    back exactly, Predictor(checkpoint=) runs it, and a system without a
    generator loads it (the file's generator ignored)."""
    system = port_system(bundle)
    system.train_step(make_batch(2), parity=1)
    path = str(tmp_path / "model_0.pt")
    ckpt.save_model(system, path)
    enc, gen = load_checkpoint(path)
    for mine, theirs in ((system.encoder.state_dict(), enc),
                         (system.generator.state_dict(), gen)):
        assert set(mine) == set(theirs)
        assert all(torch.equal(v, theirs[k]) for k, v in mine.items())

    bare = port_system(bundle, generator=False)
    ckpt.load_model(bare, path)
    assert bare.generator is None
    assert all(torch.equal(v, enc[k]) for k, v in bare.encoder.state_dict().items())

    pred = Predictor(checkpoint=path, device="cpu", bundle=bundle, config=system.config,
                     backbone_stages=STAGES)
    img = make_batch(3)["img"]
    want = {k: v.numpy() for k, v in system.infer(torch.from_numpy(img)).items()}
    got = pred(img)
    for k in ("expression_params", "vertices", "rendered_img"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_state(bundle):
    """A JAX system with tiny backbones (patched in with a restore) and its
    state, the encoder perturbed from init so batch norm and the heads are
    nontrivial."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(jax_mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    try:
        jsys = JaxSmirkSystem(JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH)), bundle,
                              steps_per_epoch=1, use_pallas=False, generator_features=8,
                              generator_res_blocks=1)
        # the state's variables from jitted inits (eager Flax init is ~4x
        # slower here); no optimizer state: the exports do not hold it
        enc0 = jax.jit(jsys.encoder.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
        gen0 = jax.jit(jsys.generator.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 6)))
        enc0 = {"params": enc0["params"], "batch_stats": enc0["batch_stats"]}
        state = TrainState(step=jnp.zeros((), jnp.int32), encoder=enc0,
                           generator={"params": gen0["params"],
                                      "batch_stats": gen0["batch_stats"]},
                           base_encoder=enc0, enc_opt=None, gen_opt=None)
        rng = np.random.default_rng(7)

        def perturb(path, x):
            x = np.asarray(x, np.float32)
            if path[-1].key == "var":
                return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
            scale = {"mean": 0.1, "bias": 0.05, "scale": 0.1}.get(path[-1].key, 0.02)
            return (x + scale * rng.normal(size=x.shape)).astype(np.float32)

        enc = jax.tree_util.tree_map_with_path(perturb, dict(state.encoder))
        state = state.replace(encoder=jax.tree_util.tree_map(jnp.asarray, enc))
        img = np.random.default_rng(6).random((B, S, S, 3), np.float32)
        out = {k: np.asarray(v) for k, v in jsys.infer(state.encoder, jnp.asarray(img)).items()}
        yield state, img, out
    finally:
        mp.undo()


def test_jax_model_export_loads(bundle, jax_state, tmp_path):
    """The JAX package's .npz model export (smirk_tpu.utils.checkpoint.
    save_model) loads through load_model and gives the JAX infer's
    outputs; its full-state .npz raises with a clear message."""
    state, img, ref = jax_state
    path = str(tmp_path / "model_0.npz")
    jax_ckpt.save_model(state, path)
    system = port_system(bundle)
    ckpt.load_model(system, path)
    out = {k: v.numpy() for k, v in system.infer(torch.from_numpy(img)).items()}
    for k in ("pose_params", "cam", "shape_params", "expression_params", "eyelid_params",
              "jaw_params", "vertices", "landmarks_fan", "landmarks_mp",
              "transformed_vertices"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.abs(ref["expression_params"]).max() > 1e-3
    agree = out["pix_to_face"] == ref["pix_to_face"]
    assert agree.mean() >= 0.995 and ref["rendered_mask"].mean() > 0.05
    np.testing.assert_allclose(out["rendered_img"][agree], ref["rendered_img"][agree],
                               rtol=0, atol=1e-4)
    gen_sd = weights.generator_state_dict_from_jax(state.generator)
    for k, v in system.generator.state_dict().items():
        assert torch.equal(v, gen_sd[k]), k

    full = str(tmp_path / "last_state.npz")
    jax_ckpt.save_state(state, full)
    for fn in (ckpt.load_model, ckpt.restore_state):
        with pytest.raises(ValueError, match="full-state"):
            fn(system, full)


def test_backbone_init_matches_jax(bundle, jax_state, tmp_path):
    """init_backbones_from_state_dicts loads raw timm-layout dicts (read by
    load_raw_state_dict from .pt and .npz) into the three feature extractors
    as the JAX importer does: the heads keep their init, conv_head /
    classifier are ignored, a shape mismatch raises."""
    state, _, _ = jax_state
    rng = np.random.default_rng(3)
    probe = port_system(bundle)

    def raw(backbone):
        sd = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
              if v.is_floating_point() else v.clone()
              for k, v in backbone.state_dict().items()}
        sd["conv_head.weight"] = torch.ones(8, 4, 1, 1)
        sd["classifier.weight"] = torch.ones(10, 8)
        return sd

    small, large = raw(probe.encoder.pose_encoder.encoder), raw(probe.encoder.shape_encoder.encoder)
    torch.save({"state_dict": small}, str(tmp_path / "small.pt"))
    np.savez(str(tmp_path / "large.npz"), **{k: v.numpy() for k, v in large.items()})
    small = weights.load_raw_state_dict(str(tmp_path / "small.pt"))
    large = weights.load_raw_state_dict(str(tmp_path / "large.npz"))

    system = port_system(bundle)
    system.encoder.load_state_dict(encoder_state_dict_from_jax(state.encoder))
    heads = {k: v.clone() for k, v in system.encoder.state_dict().items()
             if ".encoder." not in k}
    weights.init_backbones_from_state_dicts(system.encoder, small, large)
    want = encoder_state_dict_from_jax(jax_importer.init_backbones_from_state_dicts(
        dict(state.encoder), {k: v.numpy() for k, v in small.items()},
        {k: v.numpy() for k, v in large.items()}))
    got = system.encoder.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    assert all(torch.equal(got[k], v) for k, v in heads.items())
    assert torch.equal(got["expression_encoder.encoder.conv_stem.weight"],
                       large["conv_stem.weight"])

    bad = dict(small, **{"conv_stem.weight": torch.zeros(1, 1, 1, 1)})
    with pytest.raises(ValueError, match="pose_encoder.encoder.conv_stem.weight"):
        weights.init_backbones_from_state_dicts(system.encoder, bad)


def test_metric_logger_and_profiling(tmp_path, capsys):
    """MetricLogger writes the JAX package's records (its clock aside) and
    console lines; profiling.trace exports a Chrome trace, Timer times a
    call, enable_nan_debugging switches autograd's anomaly detection."""
    from smirk_tpu.utils.metrics import MetricLogger as JaxMetricLogger
    from smirk_tpu_torch.utils import profiling
    from smirk_tpu_torch.utils.metrics import MetricLogger

    logs = []
    for cls, d in ((MetricLogger, tmp_path / "port"), (JaxMetricLogger, tmp_path / "jax")):
        lg = cls(str(d), every=2)
        for step in range(4):
            lg.log(step, {"loss": 0.5 + step, "n": np.float32(step)}, epoch=1, global_step=step)
        lg.log(3, {"loss": 9.0}, phase="val", force=True)
        lg.close()
        with open(d / "metrics.jsonl") as f:
            logs.append([{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in f])
    assert logs[0] == logs[1] and len(logs[0]) == 3
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:]

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert 0 < profiling.Timer(lambda: torch.ones(8).sum(), warmup=1, iters=3)() < 5
    profiling.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
