"""PyTorch port vs the JAX package: the fuse generator (UNet + ResNet
blocks), with the weights carried by `generator_state_dict_from_jax`, in
eval and train mode, and the updated running statistics.

Tolerances: outputs 1e-4 (the frameworks sum convolutions in different
orders); running statistics 1e-5, relative to max(1, |value|) (Flax
computes the batch variance as E[x^2] - E[x]^2, the port as E[(x - E x)^2];
both round at 1e-7 of the activations' scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.models.generator import SmirkGenerator as JaxGenerator
from smirk_tpu_torch.models.generator import SmirkGenerator
from smirk_tpu_torch.utils.weights import generator_state_dict_from_jax
from torch_ref import SmirkGeneratorTorch, randomize_bn_stats
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def perturbed_variables(module, x, seed):
    """Flax init, then every leaf perturbed (BN stats and scales included)."""
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return (1.0 + 0.3 * rng.random(a.shape)).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.2 * rng.normal(size=a.shape)).astype(np.float32)
        if leaf in ("mean", "bias"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.02 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        f, {"params": v["params"], "batch_stats": v["batch_stats"]})


@pytest.mark.parametrize("features,res_blocks,size", [(8, 1, 32), (4, 2, 48)])
def test_generator_matches_flax(features, res_blocks, size):
    x = np.random.default_rng(0).random((2, size, size, 6)).astype(np.float32)
    jg = JaxGenerator(init_features=features, res_blocks=res_blocks)
    v = perturbed_variables(jg, x, 1)
    ref_eval = np.asarray(jg.apply(v, jnp.asarray(x), train=False))
    ref_train, mut = jg.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])

    g = SmirkGenerator(init_features=features, res_blocks=res_blocks)
    g.load_state_dict(generator_state_dict_from_jax(v), strict=True)
    g.eval()
    with torch.no_grad():
        out = g(torch.from_numpy(x))
    assert out.shape == (2, size, size, 3)
    np.testing.assert_allclose(out.numpy(), ref_eval, rtol=0, atol=1e-4)
    g.train()
    out = g(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_train), rtol=0, atol=1e-4)
    want = generator_state_dict_from_jax({"params": v["params"], "batch_stats": mut["batch_stats"]})
    got = g.state_dict()
    moved = 0.0
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            moved += float((want[k] - generator_state_dict_from_jax(v)[k]).abs().sum())
    assert moved > 0  # train mode updated the running statistics


def test_generator_layout_matches_reference_checkpoint():
    """Full-size Flax variables map onto the port's state dict with the
    reference generator's key names and shapes, and a reference-layout
    torch generator's state dict loads and gives the same image."""
    jg = JaxGenerator()
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   {"params": shapes["params"],
                                    "batch_stats": shapes["batch_stats"]})
    sd = generator_state_dict_from_jax(zeros)
    ours = SmirkGenerator().state_dict()
    assert set(sd) == set(ours)
    for k, t in ours.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k

    gen = torch.Generator().manual_seed(0)
    ref = SmirkGeneratorTorch(init_features=4, res_blocks=2)
    randomize_bn_stats(ref, gen)
    ref.eval()
    g = SmirkGenerator(init_features=4, res_blocks=2)
    g.load_state_dict(ref.state_dict(), strict=True)
    g.eval()
    x = torch.rand((2, 32, 32, 6), generator=gen)
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = g(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_generator_init_is_seeded():
    a = SmirkGenerator(init_features=4, res_blocks=1).init_weights(torch.Generator().manual_seed(3))
    b = SmirkGenerator(init_features=4, res_blocks=1).init_weights(torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert float(a.upconv4.bias.detach().abs().max()) == 0.0
