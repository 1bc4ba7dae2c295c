"""Reverse interop: flax -> torch export (the inverse of the importer).

Proves a model trained here can be consumed by the reference's PyTorch
stack: the exported state dict loads with strict=True into the torch
twins (tests/torch_ref.py mirrors the reference modules) and produces
matching forwards.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from smirk_tpu.models.encoders import SmirkEncoder
from smirk_tpu.utils import importer

from torch_ref import SmirkEncoderTorch
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [
    [("ds", 16, 16, 2)],
    [("ir", 24, 24, 2), ("ir", 32, 24, 1)],
    [("cn", 0, 40, 1)],
]
TINY_LARGE = [
    [("ds", 16, 16, 1)],
    [("ir", 24, 24, 2)],
    [("ir", 40, 32, 2), ("ir", 48, 32, 1)],
    [("cn", 0, 56, 1)],
]


@pytest.fixture
def tiny_archs(monkeypatch):
    from smirk_tpu.models import mobilenetv3 as mnv3

    monkeypatch.setitem(
        mnv3.ARCHS, "tf_mobilenetv3_small_minimal_100", (TINY_SMALL, 40))
    monkeypatch.setitem(
        mnv3.ARCHS, "tf_mobilenetv3_large_minimal_100", (TINY_LARGE, 56))


def _nontrivial_encoder_vars(rng_seed=0):
    """Random-init flax encoder with non-default BN stats (so a layout bug
    can't hide behind identity statistics)."""
    fmodel = SmirkEncoder(n_exp=10, n_shape=30)
    x = jnp.zeros((1, 64, 64, 3))
    variables = fmodel.init(jax.random.PRNGKey(rng_seed), x)
    rng = np.random.default_rng(rng_seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        names = [getattr(k, "key", str(k)) for k in path]
        if "batch_stats" in names:
            if names[-1] == "var":
                return (rng.uniform(0.5, 2.0, leaf.shape)).astype(leaf.dtype)
            return rng.normal(0, 0.5, leaf.shape).astype(leaf.dtype)
        if leaf.ndim >= 1 and not leaf.any():  # zero-init heads
            return rng.normal(0, 0.05, leaf.shape).astype(leaf.dtype)
        return leaf

    return fmodel, jax.tree_util.tree_map_with_path(perturb, variables)


def test_encoder_export_roundtrip(tiny_archs):
    fmodel, variables = _nontrivial_encoder_vars()
    sd = importer.export_state_dict(variables)
    zero = jax.tree_util.tree_map(np.zeros_like, variables)
    back = importer.import_state_dict(sd, zero)
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(variables)[0],
        jax.tree_util.tree_flatten_with_path(back)[0],
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(pa))


def test_flax_to_torch_forward_parity(tiny_archs):
    """strict=True load of the exported dict into the torch twin, then
    identical forwards — the reverse direction of test_encoder_parity."""
    fmodel, variables = _nontrivial_encoder_vars()
    sd = importer.add_bn_trackers(importer.export_state_dict(variables))

    tmodel = SmirkEncoderTorch(TINY_SMALL, TINY_LARGE, n_shape=30, n_exp=10)
    tmodel.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=True,
    )
    tmodel.eval()

    x = np.random.default_rng(1).random((2, 3, 64, 64), np.float32)
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(x))
    out_f = fmodel.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    for key in ["pose_params", "cam", "shape_params", "expression_params",
                "eyelid_params", "jaw_params"]:
        np.testing.assert_allclose(
            np.asarray(out_f[key]), out_t[key].numpy(),
            rtol=1e-4, atol=2e-5, err_msg=key,
        )


def test_export_cli_joint_checkpoint(tiny_archs, tmp_path):
    """CLI end-to-end: model npz -> reference-layout joint .pt that
    torch.loads, splits, and re-imports to the exact same arrays."""
    import sys

    sys.path.insert(0, "tools")
    import export_torch_ckpt

    from smirk_tpu import assets
    from smirk_tpu.config import ArchConfig, Config
    from smirk_tpu.train import SmirkSystem
    from smirk_tpu.utils import checkpoint as ckpt

    cfg = Config(image_size=32,
                 arch=ArchConfig(num_expression=10, num_shape=30))
    system = SmirkSystem(cfg, assets.load_all(), steps_per_epoch=1,
                         use_pallas=False)
    state = system.init_state(jax.random.PRNGKey(0))
    model_npz = str(tmp_path / "model.npz")
    ckpt.save_model(state, model_npz)

    out_pt = str(tmp_path / "export.pt")
    # the CLI rebuilds the template system (tiny archs stay patched
    # in-process via the fixture); overrides match the checkpoint shapes
    assert export_torch_ckpt.main(
        ["--checkpoint", model_npz, "--out", out_pt,
         "--override", "arch.num_expression=10",
         "--override", "arch.num_shape=30",
         "--override", "image_size=32"]) == 0

    sd = torch.load(out_pt, map_location="cpu", weights_only=True)
    assert any(k.startswith("smirk_encoder.") for k in sd)
    assert any(k.startswith("smirk_generator.") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)

    enc_sd, gen_sd = importer.split_smirk_checkpoint(sd)
    enc = importer.import_state_dict(
        {k: v for k, v in enc_sd.items()
         if not k.endswith("num_batches_tracked")},
        jax.tree_util.tree_map(np.zeros_like, state.encoder))
    for a, b in zip(jax.tree_util.tree_leaves(state.encoder),
                    jax.tree_util.tree_leaves(enc)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
