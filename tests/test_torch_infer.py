"""The slice as a whole: the JAX package's `SmirkSystem(use_pallas=True)
.infer` vs the port's `SmirkSystem.infer` on one bundle and one set of
encoder weights (carried by `encoder_state_dict_from_jax`), and the
port's `Predictor`.

Tolerances: parameters and geometry within 1e-4 (convolution summation
order differs between the frameworks); pix_to_face agreeing on >= 99.5 %
of pixels (a 1e-5 vertex difference can move an edge across a pixel
centre); renders within 1e-4 where pix_to_face agrees. The resize of
inputs at another size is exact: the same uint8 levels, the same float32
values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.api import Predictor as JaxPredictor
from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch import Predictor
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config
from smirk_tpu_torch.train import SmirkSystem
from smirk_tpu_torch.utils.weights import encoder_state_dict_from_jax

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B = 64, 3
ARCH = dict(num_shape=30, num_expression=10, enable_fuse_generator=False)


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=4, full_size=False)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(6).random((B, S, S, 3), np.float32)


@pytest.fixture(scope="module")
def jax_run(bundle, images):
    """JAX reference: tiny backbones (patched in with a restore), weights
    perturbed from init so BN statistics and heads are nontrivial."""
    mp = pytest.MonkeyPatch()
    mp.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    try:
        system = JaxSmirkSystem(JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH)),
                                bundle, steps_per_epoch=1, use_pallas=True)
        enc = system.init_state(jax.random.PRNGKey(0)).encoder
        rng = np.random.default_rng(7)

        def perturb(path, x):
            x = np.asarray(x, np.float32)
            leaf = path[-1].key
            if leaf == "var":
                return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
            scale = {"mean": 0.1, "bias": 0.05, "scale": 0.1}.get(leaf, 0.02)
            return (x + scale * rng.normal(size=x.shape)).astype(np.float32)

        variables = jax.tree_util.tree_map_with_path(perturb, dict(enc))
        out = system.infer(jax.tree_util.tree_map(jnp.asarray, variables),
                           jnp.asarray(images))
        return variables, {k: np.asarray(v) for k, v in out.items()}
    finally:
        mp.undo()


def port_system(bundle, variables, **kw):
    system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)), bundle,
                         device="cpu", backbone_stages=STAGES, **kw)
    system.encoder.load_state_dict(encoder_state_dict_from_jax(variables))
    return system


def compare(out, ref):
    assert set(out) == set(ref)
    for k in ("pose_params", "cam", "shape_params", "expression_params",
              "eyelid_params", "jaw_params", "vertices", "landmarks_fan",
              "landmarks_fan_3d", "landmarks_mp", "transformed_vertices"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert out["landmarks_fan"].shape[-1] == 2  # the renderer's 2D projection
    np.testing.assert_array_equal(out["raster_overflow"], ref["raster_overflow"])
    agree = out["pix_to_face"] == ref["pix_to_face"]
    assert agree.mean() >= 0.995, agree.mean()
    np.testing.assert_array_equal(out["rendered_mask"][agree], ref["rendered_mask"][agree])
    np.testing.assert_allclose(out["rendered_img"][agree], ref["rendered_img"][agree],
                               rtol=0, atol=1e-4)
    assert ref["rendered_mask"].mean() > 0.05
    for k, v in out.items():
        assert np.isfinite(v).all(), k


@pytest.mark.parametrize("compact", [None, 0])
def test_infer_matches_jax(bundle, images, jax_run, compact):
    """Compact layout (auto budget) and padded layout (raster_compact=0)
    both match the JAX package's default inference."""
    variables, ref = jax_run
    system = port_system(bundle, variables, raster_compact=compact)
    out = {k: v.numpy() for k, v in system.infer(torch.from_numpy(images)).items()}
    compare(out, ref)
    assert np.abs(ref["expression_params"]).max() > 1e-3


def test_predictor_checkpoint_encode_render(bundle, images, jax_run, tmp_path):
    """Predictor loads a reference-layout checkpoint (`smirk_encoder.*`
    keys, .pt or .npz), and its __call__, encode and render_params agree
    with SmirkSystem.infer."""
    variables, ref = jax_run
    sd = {"smirk_encoder." + k: v for k, v in encoder_state_dict_from_jax(variables).items()}
    pt = tmp_path / "model.pt"
    torch.save(sd, pt)
    npz = tmp_path / "model.npz"
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH))
    for path in (pt, npz):
        pred = Predictor(checkpoint=str(path), device="cpu", bundle=bundle,
                         config=cfg, backbone_stages=STAGES)
        out = pred(images)
        compare(out, ref)
    enc = pred.encode(images)
    for k in enc:
        np.testing.assert_array_equal(enc[k], out[k])
    rp = pred.render_params(enc)
    for k in ("vertices", "rendered_img", "pix_to_face", "raster_overflow"):
        np.testing.assert_array_equal(rp[k], out[k])
    # uint8 input at another size goes through the resize path
    big = (np.random.default_rng(0).random((2, 80, 90, 3)) * 255).astype(np.uint8)
    out_big = pred(big)
    assert out_big["rendered_img"].shape == (2, S, S, 3)
    assert np.isfinite(out_big["vertices"]).all()
    with pytest.raises(ValueError, match="landmarks batch"):
        pred(images, landmarks=np.zeros((B + 1, 68, 2)))


# input (H, W) -> model size: down, up, one axis kept, strong and odd ratios
RESIZE_CASES = [((80, 90), 64), ((40, 50), 64), ((64, 100), 64),
                ((300, 257), 224), ((7, 13), 224)]


@pytest.mark.parametrize("hw,size", RESIZE_CASES)
def test_prepare_resize_matches_jax(bundle, hw, size):
    """Predictor's resize path equals the JAX package's (Pillow's bicubic
    on uint8) exactly, on noise and on a smooth image, from uint8 and from
    float input."""
    jp = JaxPredictor.__new__(JaxPredictor)  # _prepare reads only image_size
    jp.image_size = size
    pred = Predictor(device="cpu", bundle=bundle, backbone_stages=STAGES,
                     config=Config(image_size=size, arch=ArchConfig(**ARCH)))
    h, w = hw
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (np.sin(xx / 7.0) + np.cos(yy / 5.0) + 2.0) * 63.0
    u8 = np.stack([rng.integers(0, 256, (h, w, 3)),
                   np.repeat(smooth[..., None], 3, -1)]).astype(np.uint8)
    for imgs in (u8, rng.random((2, h, w, 3), np.float32)):
        ref, _ = jp._prepare(imgs, None)
        got = pred._prepare(imgs, None).numpy()
        assert got.shape == ref.shape == (2, size, size, 3)
        np.testing.assert_array_equal(got, ref)
