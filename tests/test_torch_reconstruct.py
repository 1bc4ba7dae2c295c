"""PyTorch port vs the JAX package: the reconstruct path
(`SmirkSystem.reconstruct`, its point budget, `Predictor`'s landmark crop
and `Predictor.reconstruct`), at S = 64 with tiny backbones and a
generator of 8 features / 1 ResNet block, the weights carried by
`encoder_state_dict_from_jax` / `generator_state_dict_from_jax`.

The JAX and torch random streams never match: the draws are derived in
the test from the JAX key in the JAX package's split order
(k1..k4 = split(key, 4); kf, kb = split(k1); ku, kv = split(kb);
kn, kp = split(k4)) and handed to the port.

Tolerances:
  * fed the same infer outputs and draws: the masked image within 1e-6
    (the same float32 operations) and the reconstruction within 1e-4
    (the frameworks sum convolutions in different orders), when the
    sampled faces are the same; a draw whose u lands within rounding of a
    cdf boundary may pick the neighbouring face (the two cumulative sums
    round differently in the last bit), and such draws are counted and
    bounded, and held exactly with the JAX package's faces injected;
  * the point budget exactly, over every float32 draw in [0, 1);
  * the whole slice: the crop within 1e-5, its landmarks within 1e-4, the
    hull exactly, the masked images agreeing (within 1e-5) on >= 99 % of
    pixels, since a 1e-5 vertex difference can move a render edge or a
    sampled point across a pixel centre; the reconstruction's mean |diff|
    under 2e-3: a disagreeing input pixel moves the output within the
    generator's receptive field, and 1 % of pixels at an input
    difference of at most 1 bound the mean input difference by 1e-2,
    which eval-mode batch norm and the convolutions do not amplify by
    more than a few tenths on average here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smirk_tpu.masking as JMM_pkg
from smirk_tpu.api import Predictor as JaxPredictor
from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.data import transforms as JT
from smirk_tpu.masking import masking as JMM
from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch import Predictor
from smirk_tpu_torch.api import load_checkpoint, load_weights
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config
from smirk_tpu_torch.data import transforms as T
from smirk_tpu_torch.masking import masking as M
from smirk_tpu_torch.train import SmirkSystem
from smirk_tpu_torch.train.trainer import point_budget
from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)
from test_torch_train import jax_init_state
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B = 64, 3
ARCH = dict(num_shape=30, num_expression=10)
GEN = dict(generator_features=8, generator_res_blocks=1)
N_UPPER = int(0.01 * 5.0 * S * S)  # Config's mask_ratio x mask_ratio_mul
FRAME_HW = (150, 120)


def t(x):
    return torch.from_numpy(np.array(x))


def perturb(tree, seed):
    """Every leaf moved from init (BN statistics and scales included)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
        scale = {"mean": 0.1, "bias": 0.05, "scale": 0.1}.get(leaf, 0.02)
        return (x + scale * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, dict(tree))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX system (tiny backbones patched in with a restore, the
    Pallas raster in interpret mode), perturbed weights, and seeded frames
    with one 478-point landmark ellipse each."""
    mp = pytest.MonkeyPatch()
    mp.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    try:
        bundle = procedural_bundle(seed=4, full_size=False)
        system = JaxSmirkSystem(JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH)),
                                bundle, steps_per_epoch=1, use_pallas=True, **GEN)
        state = jax_init_state(system, jax.random.PRNGKey(0), S)
        enc = perturb(state.encoder, 7)
        gen = perturb({"params": state.generator["params"],
                       "batch_stats": state.generator["batch_stats"]}, 8)
        rng = np.random.default_rng(9)
        frames = (rng.random((B,) + FRAME_HW + (3,)) * 255).astype(np.uint8)
        theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
        lmks = np.stack([np.stack([60 + (30 + 5 * b) * np.cos(theta) + 3 * b,
                                   75 + (40 - 4 * b) * np.sin(theta)], 1)
                         for b in range(B)]).astype(np.float32)
        lmks += rng.normal(0, 1.5, lmks.shape).astype(np.float32)
        jp = JaxPredictor.__new__(JaxPredictor)  # _prepare reads only image_size
        jp.image_size = S
        yield {"bundle": bundle, "system": system, "enc": enc, "gen": gen,
               "frames": frames, "lmks": lmks, "jp": jp}
    finally:
        mp.undo()


def port_system(ref):
    system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)), ref["bundle"],
                         device="cpu", backbone_stages=STAGES, **GEN)
    system.encoder.load_state_dict(encoder_state_dict_from_jax(ref["enc"]))
    system.generator.load_state_dict(generator_state_dict_from_jax(ref["gen"]))
    return system


def tiny_predictor(ref, checkpoint):
    """Predictor(checkpoint, use_generator=True) around the tiny system:
    Predictor builds the generator at its default width, the JAX
    reference's is 8 features / 1 block."""
    pred = Predictor.__new__(Predictor)
    pred.system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)), ref["bundle"],
                              device="cpu", backbone_stages=STAGES, **GEN)
    pred.use_generator = True
    load_weights(pred.system, checkpoint, True)
    pred.image_size, pred.device = S, pred.system.device
    return pred


def jax_draws(key, n_img):
    """The JAX package's reconstruct draws for `key`, as the port's
    `draws` (bary from the two uniforms through the port's reflection)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kf, kb = jax.random.split(k1)
    ku, kv = jax.random.split(kb)
    kn, kp = jax.random.split(k4)
    u = np.asarray(jax.random.uniform(kf, (n_img, N_UPPER)))
    bu, bv = (np.asarray(jax.random.uniform(k, (n_img, N_UPPER))) for k in (ku, kv))
    return {
        "u": t(u), "bary": M.random_barycentric((n_img, N_UPPER), u=t(bu), v=t(bv)),
        "rsing": t(jax.random.randint(k2, (n_img,), 0, 2) * 2 - 1),
        "rscale": t(jax.random.uniform(k3, (n_img,))),
        "noise": t(jax.random.normal(kn, (n_img, S, S, 3))),
        "drop_centers": t(np.asarray(jax.random.bernoulli(kp, 0.01, (n_img, S, S, 1)),
                                     np.float32)),
    }


def jax_reconstruct(ref, imgs, hull, key, monkeypatch=None):
    """JAX infer + reconstruct on prepared images; with monkeypatch, the
    point budget reconstruct hands to transfer_pixels is captured."""
    system = ref["system"]
    out = system.infer(ref["enc"], jnp.asarray(imgs))
    seen = {}
    if monkeypatch is not None:
        orig = JMM_pkg.transfer_pixels

        def capture(*a, valid_count=None, **k):
            seen["rbound"] = np.asarray(valid_count)
            return orig(*a, valid_count=valid_count, **k)

        monkeypatch.setattr(JMM_pkg, "transfer_pixels", capture)
    masked, recon = system.reconstruct(ref["gen"], out, jnp.asarray(imgs),
                                       jnp.asarray(hull), key)
    return ({k: np.asarray(v) for k, v in out.items()}, np.asarray(masked),
            np.asarray(recon), seen.get("rbound"))


def test_reconstruct_matches_jax(jax_ref, monkeypatch):
    """(a) SmirkSystem.reconstruct fed the JAX infer outputs and the JAX
    draws: masked within 1e-6, reconstruction within 1e-4; the budget the
    JAX code computed equals point_budget's."""
    monkeypatch.delenv("SMIRK_SAMPLE_GUMBEL", raising=False)
    ref = jax_ref
    imgs = np.random.default_rng(1).random((B, S, S, 3), np.float32)
    hull = np.stack([JT.convex_hull_mask(k, (S, S)) for k in
                     jax_ref["lmks"] * (S / FRAME_HW[1])])[..., None]
    key = jax.random.PRNGKey(3)
    out_j, masked_j, recon_j, rbound_j = jax_reconstruct(ref, imgs, hull, key, monkeypatch)
    assert out_j["rendered_mask"].mean() > 0.05
    draws = jax_draws(key, B)
    np.testing.assert_array_equal(
        point_budget(draws["rsing"], draws["rscale"], N_UPPER, 5.0).numpy(), rbound_j)
    assert rbound_j.min() < N_UPPER and rbound_j.max() > 0

    system = port_system(ref)
    out = {k: t(v) for k, v in out_j.items()}
    # the faces each draw picks, in both packages
    faces = t(np.asarray(ref["bundle"]["faces"])).long()
    _, cj = JMM.sample_mesh_points(
        jax.random.split(key, 4)[0], jnp.asarray(out_j["transformed_vertices"]),
        ref["system"].flame.faces, ref["system"].face_probabilities, N_UPPER, S,
        incidence=ref["system"].flame_incidence)
    _, ct = M.sample_mesh_points(out["transformed_vertices"], faces,
                                 system.face_probabilities, N_UPPER, S,
                                 incidence=system.flame_incidence, u=draws["u"],
                                 bary=draws["bary"])
    np.testing.assert_array_equal(ct["barycentric_coords"].numpy(),
                                  np.asarray(cj["barycentric_coords"]))
    flips = ct["sampled_faces_indices"].numpy() != np.asarray(cj["sampled_faces_indices"])
    assert flips.sum() <= 2, flips.sum()
    print(f"boundary draws: {flips.sum()} of {flips.size}; budgets {rbound_j}")

    coords = {"sampled_faces_indices": t(cj["sampled_faces_indices"]).long(),
              "barycentric_coords": t(cj["barycentric_coords"])}
    masked_c, recon_c = system.reconstruct(out, t(imgs), t(hull),
                                           draws=dict(draws, coords=coords))
    np.testing.assert_allclose(masked_c.numpy(), masked_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(recon_c.numpy(), recon_j, rtol=0, atol=1e-4)
    masked, recon = system.reconstruct(out, t(imgs), t(hull), draws=draws)
    if not flips.any():
        np.testing.assert_array_equal(masked.numpy(), masked_c.numpy())
        np.testing.assert_array_equal(recon.numpy(), recon_c.numpy())
    else:  # only the flipped draws' pixels may differ
        assert (np.abs(masked.numpy() - masked_j).max(-1) > 1e-6).sum() <= 2 * flips.sum()
    assert np.isfinite(recon.numpy()).all() and recon.shape == (B, S, S, 3)


def test_point_budget_matches_jax_every_draw():
    """(b) rbound = int(n_upper / mul * r ** rsing), r = u * (mul - 1) + 1,
    as the JAX package writes it (smirk_tpu/train/trainer.py, reconstruct),
    equals point_budget over every float32 u that jax.random.uniform can
    draw (2^23 of them) and both signs, at 224 px and at the test's size."""
    m = np.arange(1 << 23, dtype=np.uint32)
    u = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    for n_upper, mul in ((int(0.01 * 5.0 * 224 * 224), 5.0), (N_UPPER, 5.0), (1254, 3.0)):
        for s in (-1, 1):
            rsing = np.full(u.shape, s, np.int32)

            @jax.jit
            def jax_rbound(u, rsing):
                rscale = u * (mul - 1) + 1
                return (n_upper / mul * (rscale ** rsing)).astype(jnp.int32)

            want = np.asarray(jax_rbound(jnp.asarray(u), jnp.asarray(rsing)))
            got = point_budget(torch.from_numpy(rsing), torch.from_numpy(u), n_upper, mul)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{n_upper} {s}")


def test_predictor_reconstruct_matches_jax(jax_ref, tmp_path):
    """(c) The whole slice: Predictor(use_generator=True, a joint
    checkpoint).reconstruct against the JAX package's _prepare + infer +
    reconstruct, composed by hand, with the same key's draws."""
    ref = jax_ref
    frames, lmks = ref["frames"], ref["lmks"]
    imgs_j, kpts_j = ref["jp"]._prepare(frames, lmks)
    hull_j = np.stack([JT.convex_hull_mask(k, (S, S)) for k in kpts_j])
    key = jax.random.PRNGKey(0)
    out_j, masked_j, recon_j, _ = jax_reconstruct(ref, imgs_j, hull_j[..., None], key)

    sd = {**{"smirk_encoder." + k: v for k, v in encoder_state_dict_from_jax(ref["enc"]).items()},
          **{"smirk_generator." + k: v for k, v in generator_state_dict_from_jax(ref["gen"]).items()}}
    path = tmp_path / "smirk.pt"
    torch.save(sd, path)
    pred = tiny_predictor(ref, str(path))
    got = pred.reconstruct(frames, lmks, draws=jax_draws(key, B))
    np.testing.assert_allclose(got["cropped_img"], imgs_j, rtol=0, atol=1e-5)
    _, kpts = pred._crop(frames, lmks)
    np.testing.assert_allclose(kpts, kpts_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(T.convex_hull_mask(kpts, (S, S), "cpu").numpy(), hull_j)
    assert 0.2 < hull_j.mean() < 0.8
    for k in ("expression_params", "vertices", "transformed_vertices"):
        np.testing.assert_allclose(got[k], out_j[k], rtol=1e-4, atol=1e-4, err_msg=k)
    agree = (np.abs(got["masked_img"] - masked_j) <= 1e-5).all(-1)
    assert agree.mean() >= 0.99, agree.mean()
    diff = np.abs(got["reconstructed_img"] - recon_j)
    assert diff.mean() < 2e-3, diff.mean()
    if agree.all():  # the same generator input up to rounding
        assert diff.max() <= 1e-4, diff.max()
    print(f"masked agree on {agree.mean():.5f}; reconstruction mean |diff| "
          f"{diff.mean():.3g}, max {diff.max():.3g}")
    assert set(got) == set(out_j) | {"cropped_img", "masked_img", "reconstructed_img"}
    for k, v in got.items():
        assert isinstance(v, np.ndarray) and np.isfinite(v).all(), k
    # seeded draws: one seed, one result
    a, b = (pred.reconstruct(frames[:1], lmks[0], seed=5)["masked_img"] for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_predictor_landmark_crop_matches_jax(jax_ref):
    """(d) Predictor(landmarks=) crops as the JAX package's _prepare does
    and __call__ matches its infer on that crop; one landmark set serves
    the batch; float input in [0, 1] and a single (H,W,3) image too."""
    ref = jax_ref
    frames, lmks = ref["frames"], ref["lmks"]
    pred = Predictor(device="cpu", bundle=ref["bundle"],
                     config=Config(image_size=S, arch=ArchConfig(**ARCH)),
                     backbone_stages=STAGES)
    pred.system.encoder.load_state_dict(encoder_state_dict_from_jax(ref["enc"]))
    imgs_j, _ = ref["jp"]._prepare(frames, lmks)
    want = {k: np.asarray(v) for k, v in
            ref["system"].infer(ref["enc"], jnp.asarray(imgs_j)).items()}
    got = pred(frames, landmarks=lmks)
    for k in ("pose_params", "cam", "shape_params", "expression_params", "vertices",
              "landmarks_fan", "landmarks_mp", "transformed_vertices"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    agree = got["pix_to_face"] == want["pix_to_face"]
    assert agree.mean() >= 0.995
    np.testing.assert_allclose(got["rendered_img"][agree], want["rendered_img"][agree],
                               rtol=0, atol=1e-4)
    one = pred._prepare(frames, lmks[1]).numpy()
    np.testing.assert_array_equal(one, pred._prepare(frames, np.stack([lmks[1]] * B)).numpy())
    np.testing.assert_allclose(one, ref["jp"]._prepare(frames, lmks[1])[0], rtol=0, atol=1e-5)
    fl = frames.astype(np.float32) / 255.0
    np.testing.assert_allclose(pred._prepare(fl, lmks).numpy(), ref["jp"]._prepare(fl, lmks)[0],
                               rtol=0, atol=1e-5)
    single, kp = pred._crop(frames[2], lmks[2])
    ref_single, ref_kp = ref["jp"]._prepare(frames[2], lmks[2])
    np.testing.assert_allclose(single.numpy(), ref_single, rtol=0, atol=1e-5)
    np.testing.assert_allclose(kp, ref_kp, rtol=0, atol=1e-4)


def test_reconstruct_errors(jax_ref, tmp_path):
    """(e) reconstruct raises without the generator or the landmarks, on a
    landmark batch that does not match; a bare encoder checkpoint has no
    generator part; without a card the entry points raise unless the
    caller asks for the CPU."""
    ref = jax_ref
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH))
    kw = dict(device="cpu", bundle=ref["bundle"], backbone_stages=STAGES)
    frames, lmks = ref["frames"][:2], ref["lmks"][:2]
    with pytest.raises(ValueError, match="use_generator=True"):
        Predictor(config=cfg, **kw).reconstruct(frames, lmks)
    no_gen = Config(image_size=S, arch=ArchConfig(enable_fuse_generator=False, **ARCH))
    pred = Predictor(config=no_gen, use_generator=True, **kw)
    assert not pred.use_generator
    with pytest.raises(ValueError, match="use_generator=True"):
        pred.reconstruct(frames, lmks)
    with pytest.raises(ValueError, match="fuse generator"):
        pred.system.reconstruct({}, torch.zeros((1, S, S, 3)), torch.ones((1, S, S, 1)))
    pred = Predictor(config=cfg, use_generator=True, **kw)
    with pytest.raises(ValueError, match="needs landmarks"):
        pred.reconstruct(frames, None)
    with pytest.raises(ValueError, match="landmarks batch"):
        pred.reconstruct(frames, ref["lmks"])
    bare = tmp_path / "enc.npz"
    np.savez(bare, **{k: v.numpy() for k, v in pred.system.encoder.state_dict().items()})
    enc, gen = load_checkpoint(str(bare))
    assert gen == {} and set(enc) == set(pred.system.encoder.state_dict())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(use_generator=True, bundle=ref["bundle"], config=cfg,
                      backbone_stages=STAGES)
