"""PyTorch port vs the JAX package and the reference goldens: mesh-anchored
pixel sampling and mask composition (smirk_tpu_torch.masking).

The goldens (`tests/fixtures/masking_golden.npz`) come from the reference
PyTorch implementation and need no assets. Against JAX, the draws are
derived in the test from a JAX key in the JAX package's split order and
handed to the port (JAX and torch streams never match).

Tolerances: the goldens as in tests/test_masking.py (area 1e-5 relative,
probabilities 1e-4 relative, points exact on > 99 % of them and off by one
pixel elsewhere, images 1e-6). Against JAX: images exact; sampled faces
exact except where u lands within rounding (8u x the running total) of a
cdf boundary, since the two cumulative sums may round differently in the
last bit; such draws are counted and bounded.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.masking import masking as JMM
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.masking import masking as M
from smirk_tpu_torch.render import geometry
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "masking_golden.npz"))
S = 32
U = 2.0 ** -24


def nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def t(x):
    return torch.from_numpy(np.array(x))


def test_golden_area_probabilities_points():
    verts = t(FIX["verts"])
    faces = t(FIX["faces"].astype(np.int64))
    fv = verts.reshape(-1, 3)[faces][None]
    np.testing.assert_allclose(M.triangle_area_xy(fv).numpy(), FIX["tri_area"],
                               rtol=1e-5, atol=1e-6)
    w = M.face_sampling_probabilities(verts, faces, t(FIX["probs"]))
    np.testing.assert_allclose(w.numpy(), FIX["weighted_probs"], rtol=1e-4, atol=1e-6)
    fidx, cidx = geometry.build_vertex_face_incidence(FIX["faces"], verts.shape[1])
    w_inc = M.face_sampling_probabilities(verts, faces, t(FIX["probs"]),
                                          incidence=(t(fidx).long(), t(cidx).long()))
    np.testing.assert_allclose(w_inc.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)
    coords = {"sampled_faces_indices": t(FIX["coords_idx"].astype(np.int64)),
              "barycentric_coords": t(FIX["coords_bary"])}
    pts, back = M.sample_mesh_points(verts, faces, t(FIX["probs"]),
                                     FIX["coords_idx"].shape[1], S, coords=coords)
    assert back is coords
    diff = np.abs(pts.numpy().astype(np.int64) - FIX["npoints"][..., :2].astype(np.int64))
    assert (diff <= 1).all() and (diff == 0).mean() > 0.99


def test_golden_transfer_and_compose():
    img = t(nhwc(FIX["img"]))
    pts = t(FIX["pts"].astype(np.int32))
    extra = M.transfer_pixels(img, pts, pts)
    np.testing.assert_allclose(extra.numpy(), nhwc(FIX["extra"]), atol=1e-6)
    out = M.compose_mask(img, t(nhwc(FIX["hull"])), t(nhwc(FIX["extra"])),
                         dilation_radius=3, rendered_mask=t(nhwc(FIX["rmask"])),
                         extra_noise=False, random_mask=0.0)
    np.testing.assert_allclose(out.numpy(), nhwc(FIX["masked"]), atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    """Procedural head projected to NDC at two scales, and its tables."""
    bundle = procedural_bundle(seed=3, full_size=True)
    vt = bundle["v_template"]
    verts = np.stack([vt * 7.0, vt * 6.0 + np.float32([0.05, -0.03, 0.0])]).astype(np.float32)
    verts[..., 1:] *= -1.0  # NDC: y down, z flipped, as the camera does
    faces = np.asarray(bundle["faces"])
    fidx, cidx = geometry.build_vertex_face_incidence(faces, vt.shape[0])
    return verts, faces, bundle["face_probabilities"], fidx, cidx


def test_sampling_matches_jax_with_injected_draws(mesh):
    """The same key's draws give the same faces, barycentrics and pixels,
    except where u lands on a cdf boundary within rounding."""
    verts, faces, probs, fidx, cidx = mesh
    B, N, size = verts.shape[0], 501, 224
    key = jax.random.PRNGKey(11)
    kf, kb = jax.random.split(key)
    u = np.asarray(jax.random.uniform(kf, (B, N)))
    ku, kv = jax.random.split(kb)
    bu, bv = np.asarray(jax.random.uniform(ku, (B, N))), np.asarray(jax.random.uniform(kv, (B, N)))
    pj, cj = JMM.sample_mesh_points(
        key, jnp.asarray(verts), jnp.asarray(faces, jnp.int32), jnp.asarray(probs), N, size,
        incidence=(jnp.asarray(fidx), jnp.asarray(cidx)))
    bary = M.random_barycentric((B, N), u=t(bu), v=t(bv))
    np.testing.assert_array_equal(bary.numpy(), np.asarray(cj["barycentric_coords"]))
    inc = (t(fidx).long(), t(cidx).long())
    pt, ct = M.sample_mesh_points(t(verts), t(faces).long(), t(probs), N, size,
                                  incidence=inc, u=t(u), bary=bary)
    fi, fj = ct["sampled_faces_indices"].numpy(), np.asarray(cj["sampled_faces_indices"])
    w = M.face_sampling_probabilities(t(verts), t(faces).long(), t(probs), inc)
    wj = JMM.face_sampling_probabilities(jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
                                         jnp.asarray(probs), (jnp.asarray(fidx), jnp.asarray(cidx)))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-9)
    cdf = np.cumsum(w.numpy().astype(np.float64), -1)
    target = u * cdf[:, -1:]
    bad = np.argwhere(fi != fj)
    for b, n in bad:
        f = min(fi[b, n], fj[b, n])
        assert abs(target[b, n] - cdf[b, f]) <= 8 * U * cdf[b, -1], (b, n)
    assert len(bad) <= 2, len(bad)
    same = fi == fj
    np.testing.assert_array_equal(pt.numpy()[same], np.asarray(pj)[same])
    assert (w.numpy()[np.arange(B)[:, None], fi] > 0).all()  # never a prob-0 face
    print(f"boundary draws: {len(bad)} of {fi.size}")


def test_sampler_clamps_to_last_positive_face():
    """u that rounds up to the total selects the last positive-probability
    face, never a trailing prob-0 face; an all-zero row samples uniformly."""
    fv = torch.tensor([[[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0]]])
    verts = fv.reshape(1, 3, 3).repeat(2, 1, 1)
    faces = torch.tensor([[0, 2, 1]] * 4)  # normal -z: facing the camera
    probs = torch.tensor([1.0, 1.0, 0.0, 0.0])
    face_probs = M.face_sampling_probabilities(verts, faces, probs)
    assert (face_probs[:, :2] > 0).all() and (face_probs[:, 2:] == 0).all()
    u = torch.tensor([[0.0, 0.5, 1.0], [0.999999, 1.0, 1.0]])
    _, c = M.sample_mesh_points(verts, faces, probs, 3, 32, u=u)
    idx = c["sampled_faces_indices"]
    assert int(idx.max()) == 1 and int(idx.min()) == 0
    _, c0 = M.sample_mesh_points(verts, faces, torch.zeros(4), 3, 32, u=u)
    assert int(c0["sampled_faces_indices"].max()) == 3


def test_transfer_pixels_duplicates_and_budget_match_jax():
    """Destinations hit by several points keep the last point, as XLA's
    scatter does; a per-image point budget drops the points past it."""
    rng = np.random.default_rng(5)
    B, H, N = 3, 16, 200
    img = rng.random((B, H, H, 3)).astype(np.float32)
    src = rng.integers(0, H, (B, N, 2)).astype(np.int32)
    dst = rng.integers(0, 6, (B, N, 2)).astype(np.int32)  # many repeats
    budget = np.asarray([N, 17, 0], np.int32)
    for vc in (None, budget):
        ref = JMM.transfer_pixels(jnp.asarray(img), jnp.asarray(src), jnp.asarray(dst),
                                  None if vc is None else jnp.asarray(vc))
        out = M.transfer_pixels(t(img), t(src), t(dst), None if vc is None else t(vc))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy()[2] == 0).all()


@pytest.mark.parametrize("radius", [1, 5, 10])
def test_dilate_matches_jax(radius):
    rng = np.random.default_rng(radius)
    m = (rng.random((2, 37, 29, 1)) > 0.97).astype(np.float32)
    np.testing.assert_array_equal(M._dilate(t(m), radius).numpy(),
                                  np.asarray(JMM._dilate(jnp.asarray(m), radius)))


def test_compose_mask_matches_jax_with_injected_draws():
    """compose_mask with the JAX key's noise and drop centres equals the
    JAX package's output exactly."""
    rng = np.random.default_rng(2)
    B, H = 2, 48
    img = rng.random((B, H, H, 3)).astype(np.float32)
    hull = (rng.random((B, H, H, 1)) > 0.3).astype(np.float32)
    rmask = (rng.random((B, H, H, 1)) > 0.6).astype(np.float32)
    extra = np.where(rng.random((B, H, H, 1)) > 0.9, img, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kn, kp = jax.random.split(key)
    for random_mask in (0.01, 0.005):
        noise = np.asarray(jax.random.normal(kn, extra.shape))
        centres = np.asarray(jax.random.bernoulli(kp, random_mask, (B, H, H, 1)), np.float32)
        ref = JMM.compose_mask(key, jnp.asarray(img), jnp.asarray(hull), jnp.asarray(extra),
                               dilation_radius=10, rendered_mask=jnp.asarray(rmask),
                               extra_noise=True, random_mask=random_mask)
        out = M.compose_mask(t(img), t(hull), t(extra), dilation_radius=10,
                             rendered_mask=t(rmask), extra_noise=True,
                             random_mask=random_mask, noise=t(noise),
                             drop_centers=t(centres))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert not out.requires_grad


def test_generator_draws_are_seeded():
    """Without injected draws, one torch.Generator seed gives one result."""
    verts = t(FIX["verts"])
    faces = t(FIX["faces"].astype(np.int64))
    probs = t(FIX["probs"])
    runs = [M.sample_mesh_points(verts, faces, probs, 64, S,
                                 generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
    bary = runs[0][1]["barycentric_coords"]
    assert (bary >= 0).all() and torch.allclose(bary.sum(-1), torch.ones(()), atol=1e-6)
    pts = runs[0][0]
    assert (pts >= 0).all() and (pts < S).all()
    img = torch.rand((1, S, S, 3), generator=torch.Generator().manual_seed(0))
    a, b = (M.compose_mask(img, torch.ones((1, S, S, 1)), img, 3,
                           generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b)
