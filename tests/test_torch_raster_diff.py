"""PyTorch port vs the JAX package: the differentiable raster
(`rasterize_planes_diff`: K3 forward, K4 + K5 backward), `image_to_tiles`,
`Renderer.render`, and the custom backward against dense autograd.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances.
* Bins, overflow and the slots of agreeing pixels are exact; pix_to_face
  is exact except at edge or depth ties, which are counted and bounded as
  in test_torch_raster.py; values are held to the same rounding bound as
  the inference raster's normals (8u x the magnitudes rounded).
* K4 and K5 reorder fp32 sums (a one-hot matmul in JAX, a scatter here):
  each element within 1e-5 x the sum of the magnitudes of its terms.
* Gradients: within 1e-4 x the scale of `dense_gradient_and_scale`, the
  sum over the pixels a face won of kappa^2 |per-pixel term|, kappa the
  pixel's edge condition number (sum of |a x|, |b y|, |x_j y_k|, |y_j x_k|
  over |2 area|). The planes raster evaluates edge and attribute planes in
  absolute coordinates and its gradient differentiates 1/area, so fp32
  rounding is amplified by kappa twice; at 224 px small faces make kappa
  large, and no fixed epsilon holds there. 1e-4: a face's gradient sums
  up to ~1000 pixel terms in an order that differs between the packages
  (and between runs of the card's atomics), and n fp32 terms in any order
  are within n*u of their magnitudes, 1000 u = 6e-5. Faces that own a tie
  pixel of pix_to_face get another gradient in the two packages; they are
  excluded, counted and bounded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu.render.renderer import Renderer as JaxRenderer
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as TR
from test_torch_raster import check_normals, check_p2f_zbuf, make_scene
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

SUM_RTOL = 1e-5
GRAD_RTOL = 1e-4
MAX_TIE_FACES = 8


@pytest.fixture(scope="module")
def bundles():
    return {False: procedural_bundle(seed=1, full_size=False),
            True: procedural_bundle(seed=1, full_size=True)}


def assert_within(got, want, scale, keep=None, rtol=SUM_RTOL):
    """Every element (of the faces in `keep`, (B,F) bool) within rtol x
    scale; -> the worst ratio."""
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    ratio = (got.double() - want.double()).abs() / (rtol * scale.double() + 1e-30)
    if keep is not None:
        ratio = ratio[keep]
    worst = float(ratio.max())
    assert worst <= 1.0, worst
    return worst


def tie_faces(p2f_a, p2f_b):
    """(B,F)-indexable set of faces owning a pixel where the two
    pix_to_face maps differ."""
    bad = p2f_a != p2f_b
    faces = set()
    for b, r, c in np.argwhere(bad):
        faces |= {(b, int(f)) for f in (p2f_a[b, r, c], p2f_b[b, r, c]) if f >= 0}
    return faces


def to_tiles(img, size):
    return TR.image_to_tiles(torch.as_tensor(np.asarray(img)), size).numpy()


DIFF_CASES = [
    (False, 64, 2, 0, "auto"), (False, 64, 2, 0, None), (False, 64, 2, 0, 8),
    (False, 100, 2, 5, "auto"),
    (True, 224, 1, 3, "auto"),
]


@pytest.mark.parametrize("full,size,B,seed,compact", DIFF_CASES)
def test_rasterize_planes_diff_matches_jax(bundles, full, size, B, seed, compact):
    """Forward (pix_to_face, slots, bins, overflow, values) and gradient of
    rasterize_planes_diff vs the JAX package's, on the compact layout at
    the auto budget, the padded layout and a truncated budget."""
    r, _, _, fv, fn = make_scene(bundles[full], size, B, seed)
    compact = r.raster_compact if compact == "auto" else compact
    cap = r.bin_capacity
    fvj, fnj = jnp.asarray(fv.numpy()), jnp.asarray(fn.numpy())

    vt, pt, zt, st, bt, ot = TR._v5_impl(fv, fn, size, cap, compact)
    vj, pj, zj, sj, bj, oj = JR._v5_impl(fvj, fnj, size, cap, True, compact, 0.95, True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    n_bad = check_p2f_zbuf(pt, pj, zt, zj, fv, size)
    agree = pt.numpy() == np.asarray(pj)
    check_normals(vt, vj, np.where(agree, pt.numpy(), -1), fv, fn, size)
    agree_t = to_tiles(agree, size).astype(bool)
    Tp = st.shape[1]
    np.testing.assert_array_equal(st.numpy()[agree_t], np.asarray(sj)[:, :Tp][agree_t])
    assert (st.numpy() >= 0).sum() > 0
    if compact is not None and compact < r.raster_compact:
        assert int(ot.min()) > 0

    w = np.random.default_rng(seed).normal(size=vt.shape).astype(np.float32)
    fvt, fnt = fv.clone().requires_grad_(True), fn.clone().requires_grad_(True)
    vals, mask, p2f, ovf = TR.rasterize(fvt, fnt, size, cap, compact=compact)
    assert not mask.requires_grad and not p2f.requires_grad
    (vals * torch.from_numpy(w)).sum().backward()

    def loss(a, b):
        v, _, _, _ = JR.rasterize_planes_diff(a, b, size, cap, True, compact, 0.95, True)
        return (v * jnp.asarray(w)).sum()

    gj_fv, gj_fn = jax.grad(loss, argnums=(0, 1))(fvj, fnj)
    _, sc_fv, _, sc_fn = TR.dense_gradient_and_scale(p2f, fv, fn, torch.from_numpy(w))
    keep = torch.ones(fv.shape[:2], dtype=torch.bool)
    ties = tie_faces(pt.numpy(), np.asarray(pj))
    for b, f in ties:
        keep[b, f] = False
    assert len(ties) <= MAX_TIE_FACES, len(ties)
    r_fv = assert_within(fvt.grad, gj_fv, sc_fv, keep, GRAD_RTOL)
    r_fn = assert_within(fnt.grad, gj_fn, sc_fn, keep, GRAD_RTOL)
    assert float(fvt.grad[..., 2].abs().max()) == 0.0  # no gradient to z
    print(f"tie pixels {n_bad}, tie faces excluded {len(ties)}; worst gradient "
          f"ratios fv {r_fv:.3g}, attr {r_fn:.3g}")


@pytest.mark.parametrize("full,size,B,seed", [(False, 64, 2, 0), (True, 224, 1, 3)])
def test_moments_and_fold_plain_match_jax(bundles, full, size, B, seed):
    """image_to_tiles equals JAX's; K4's plain version equals
    segment_reduce_moments and K5's fold_slots_to_faces (Pallas,
    interpret mode) on the same slots, cotangent and bins."""
    r, _, _, fv, fn = make_scene(bundles[full], size, B, seed)
    cap = r.bin_capacity
    _, _, _, slots, bins, _ = TR._v5_impl(fv, fn, size, cap, r.raster_compact)
    g = np.random.default_rng(seed).normal(size=(B, size, size, 3)).astype(np.float32)
    g_t = TR.image_to_tiles(torch.from_numpy(g), size)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(JR.image_to_tiles(jnp.asarray(g), size)))
    ours = TR.segment_moments(slots, g_t, cap, size)
    ref = JR.segment_reduce_moments(jnp.asarray(slots.numpy()), jnp.asarray(g_t.numpy()),
                                    cap, size, True)
    scale = TR.segment_sum(slots, TR.moment_rows(g_t, size).abs(), cap)
    assert_within(ours, ref, scale)
    assert float(ours.abs().sum()) > 0
    F = fv.shape[1]
    folded = TR.fold_slots_to_faces(ours, bins, F)
    ref_f = JR.fold_slots_to_faces(jnp.asarray(ours.numpy()), jnp.asarray(bins.numpy()), F, True)
    assert_within(folded, ref_f, TR.fold_slots_to_faces(ours.abs(), bins, F))
    # every slot that won a pixel lands on its bin's face
    assert float(folded.abs().sum()) > 0


@pytest.mark.parametrize("compact", ["auto", None, 24])
def test_custom_backward_matches_dense_autograd(bundles, compact):
    """The custom backward (K4 -> K5 -> attr_planes) equals autograd through
    the dense gather-based interpolation of the same pix_to_face, and the
    forward values equal the dense ones within the rounding bound."""
    size = 224
    r, _, _, fv, fn = make_scene(bundles[True], size, 1, 7)
    compact = r.raster_compact if compact == "auto" else compact
    fvt, fnt = fv.clone().requires_grad_(True), fn.clone().requires_grad_(True)
    vals, _, p2f, ovf = TR.rasterize(fvt, fnt, size, r.bin_capacity, compact=compact)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=vals.shape).astype(np.float32))
    (vals * g).sum().backward()
    d_fv, sc_fv, d_fn, sc_fn = TR.dense_gradient_and_scale(p2f, fv, fn, g)
    assert_within(fvt.grad, d_fv, sc_fv, rtol=GRAD_RTOL)
    assert_within(fnt.grad, d_fn, sc_fn, rtol=GRAD_RTOL)
    dense, _ = TR.interpolate_attributes(p2f, fv, fn)
    check_normals(vals.detach(), dense, p2f, fv, fn, size)
    if compact == 24:
        assert int(ovf.min()) > 0


def test_rasterize_rejects_wide_attributes():
    """Wide attributes (D > 6) are no longer rejected: they take the
    coverage raster (K6) and interpolate_attributes_fast (K7 + K5), with
    zero overflow; the compact budget, keyword-only, does not apply."""
    fv = torch.zeros((1, 4, 3, 3))
    vals, mask, p2f, ovf = TR.rasterize(fv, torch.zeros((1, 4, 3, 7)), 32, 32, compact=8)
    assert vals.shape == (1, 32, 32, 7) and mask.shape == (1, 32, 32, 1)
    assert int((p2f >= 0).sum()) == 0 and ovf.tolist() == [0]


@pytest.mark.parametrize("full,size,B,seed", [(False, 64, 2, 0), (True, 224, 1, 1)])
def test_render_matches_jax(bundles, full, size, B, seed):
    """Renderer.render (forward(inference=False)) vs the JAX Renderer's
    render: the shaded image where pix_to_face agrees, and the gradient of
    a weighted sum of the image to the vertices (through the normals and
    the barycentrics): max |diff| <= 1e-3 max |g_jax|."""
    bundle = bundles[full]
    r, verts, cam, _, _ = make_scene(bundle, size, B, seed)
    jr = JaxRenderer(bundle, image_size=size, use_pallas=True)
    w = np.random.default_rng(seed).random((B, size, size, 3)).astype(np.float32)

    def jloss(v):
        out = jr(v, jnp.asarray(cam))
        return (out["rendered_img"] * jnp.asarray(w)).sum(), out

    (_, ref), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(verts))
    v = torch.from_numpy(verts).requires_grad_(True)
    out = r(v, torch.from_numpy(cam))
    (out["rendered_img"] * torch.from_numpy(w)).sum().backward()
    assert set(out) == set(ref) - {"landmarks_fan", "landmarks_mp"} or set(out) == set(ref)
    np.testing.assert_array_equal(out["raster_overflow"].numpy(), np.asarray(ref["raster_overflow"]))
    p2f, pj = out["pix_to_face"].numpy(), np.asarray(ref["pix_to_face"])
    agree = p2f == pj
    assert agree.mean() >= 0.999, agree.mean()
    img, img_j = out["rendered_img"].detach().numpy(), np.asarray(ref["rendered_img"])
    np.testing.assert_allclose(img[agree], img_j[agree], rtol=0, atol=1e-4)
    gj = np.asarray(gj)
    diff = np.abs(v.grad.numpy() - gj).max()
    assert diff <= 1e-3 * np.abs(gj).max(), (diff, np.abs(gj).max())
    assert out["rendered_mask"].numpy().mean() > 0.05
    print(f"render max diff {np.abs(img - img_j)[agree].max():.3g}; vertex "
          f"gradient max diff {diff:.3g} of max {np.abs(gj).max():.3g}")
