"""PyTorch port vs the JAX package: MobileNetV3-minimal encoders, with the
weights carried by `encoder_state_dict_from_jax`.

Tolerance 1e-4: the two frameworks sum convolutions in different orders
(XLA's CPU convolution vs oneDNN), which at these widths moves fp32
outputs by ~1e-6..1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.models.encoders import SmirkEncoder as JaxSmirkEncoder
from smirk_tpu_torch.models import mobilenetv3 as tmnv3
from smirk_tpu_torch.models.encoders import SmirkEncoder
from smirk_tpu_torch.utils.weights import encoder_state_dict_from_jax
from torch_ref import SmirkEncoderTorch, randomize_bn_stats

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
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(variables, seed):
    """Give every leaf nontrivial values (BN stats and scales included) so
    the comparison exercises them; variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        leaf = path[-1].key
        x = np.asarray(x, np.float32)
        if leaf == "var":
            return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
        if leaf in ("mean", "bias"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (x + 0.02 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture
def tiny_archs(monkeypatch):
    monkeypatch.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    monkeypatch.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 56))


@pytest.mark.parametrize("size", [64, 97])
def test_encoder_matches_jax_with_carried_weights(tiny_archs, size):
    """Odd sizes exercise the asymmetric TF-SAME padding."""
    n_shape, n_exp, B = 30, 10, 2
    jenc = JaxSmirkEncoder(n_exp=n_exp, n_shape=n_shape)
    img = np.random.default_rng(1).random((B, size, size, 3), np.float32)
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(img))
    variables = perturb(to_numpy_tree(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}), 2)
    ref = jenc.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                     jnp.asarray(img), train=False)

    enc = SmirkEncoder(n_exp=n_exp, n_shape=n_shape, pose_stages=TINY_SMALL,
                       shape_stages=TINY_LARGE, expression_stages=TINY_LARGE)
    enc.load_state_dict(encoder_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(img))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.abs(np.asarray(ref["expression_params"])).max() > 1e-3
    assert (np.asarray(ref["eyelid_params"]) >= 0).all()


def test_full_size_layout_matches_jax(monkeypatch):
    """Every full-size encoder variable of the JAX package maps onto the
    port's state dict with the same shape, and the published stage tables
    are the JAX package's."""
    assert tmnv3.SMALL_MINIMAL == mnv3.SMALL_MINIMAL
    assert tmnv3.LARGE_MINIMAL == mnv3.LARGE_MINIMAL
    # other test modules write tiny tables into mnv3.ARCHS without a
    # restore; pin the published ones for this test
    monkeypatch.setitem(mnv3.ARCHS, SMALL, (mnv3.SMALL_MINIMAL, 576))
    monkeypatch.setitem(mnv3.ARCHS, LARGE, (mnv3.LARGE_MINIMAL, 960))
    jenc = JaxSmirkEncoder()
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   {"params": shapes["params"],
                                    "batch_stats": shapes["batch_stats"]})
    sd = encoder_state_dict_from_jax(zeros)
    enc = SmirkEncoder()
    ours = enc.state_dict()
    assert set(sd) == set(ours)
    for k, v in ours.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    enc.load_state_dict(sd, strict=True)


def test_reference_layout_state_dict_loads():
    """A reference-layout encoder (tests/torch_ref.py, the checkpoint's key
    names) loads with load_state_dict and gives the same outputs."""
    gen = torch.Generator().manual_seed(0)
    ref = SmirkEncoderTorch(TINY_SMALL, TINY_LARGE, n_shape=30, n_exp=10)
    randomize_bn_stats(ref, gen)
    ref.eval()
    enc = SmirkEncoder(n_exp=10, n_shape=30, pose_stages=TINY_SMALL,
                       shape_stages=TINY_LARGE, expression_stages=TINY_LARGE)
    enc.load_state_dict(ref.state_dict(), strict=True)
    img = torch.from_numpy(np.random.default_rng(3).random((2, 64, 64, 3), np.float32))
    with torch.no_grad():
        want = ref(img.permute(0, 3, 1, 2))
        got = enc(img)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_init_weights_head_quirks():
    enc = SmirkEncoder(n_exp=10, n_shape=30, pose_stages=TINY_SMALL,
                       shape_stages=TINY_LARGE, expression_stages=TINY_LARGE)
    enc.init_weights(torch.Generator().manual_seed(0))
    pose = enc.pose_encoder.pose_cam_layers[0]
    assert float(pose.bias[3].detach()) == 7.0
    assert float(pose.weight[3].detach().abs().max()) == 0.0
    assert float(enc.shape_encoder.shape_layers[0].weight.detach().abs().max()) == 0.0
    with torch.no_grad():
        out = enc(torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1)))
    np.testing.assert_allclose(out["cam"][:, 0].numpy(), 7.0)
    assert float(out["shape_params"].abs().max()) == 0.0
    jaw = out["jaw_params"].numpy()
    assert (jaw[:, 0] >= 0).all() and (np.abs(jaw[:, 1:]) <= 0.2).all()
    a = SmirkEncoder(n_exp=10, n_shape=30, pose_stages=TINY_SMALL,
                     shape_stages=TINY_LARGE, expression_stages=TINY_LARGE)
    a.init_weights(torch.Generator().manual_seed(0))
    for (k, v), w in zip(a.state_dict().items(), enc.state_dict().values()):
        assert torch.equal(v, w), k
