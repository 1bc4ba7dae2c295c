"""PyTorch port vs the JAX package: the coverage rasters (all pairs, K8
one face at a time, K6 on the padded layout), the payload reduction K7,
`interpolate_attributes_fast` and `rasterize` for any D, plus the
binning dispatch and `rasterize`'s keyword-only arguments.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).
Inputs are random meshes (tests/test_rasterizer.py's recipe) made with numpy.

Tolerances.
* pix_to_face and zbuf: `check_p2f_zbuf` of test_torch_raster.py (equal
  except at edge or depth ties within rounding, at most 0.1 % of pixels;
  depth within 8u of its magnitudes). The seeds below agree exactly.
* Slots and bins: equal where pix_to_face agrees.
* K7 reorders fp32 sums (a one-hot matmul in JAX, a scatter here): every
  element within 1e-5 x the sum of the magnitudes of its terms.
* Interpolated values and gradients: rtol 1e-4, atol 1e-5, as
  tests/test_rasterizer.py holds the JAX package's fast interpolation to
  its plain one; XLA contracts products into FMAs, the port does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.render import rasterizer as TR
from test_torch_raster import check_p2f_zbuf
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

SUM_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-5)


def random_mesh(seed, F=40, B=2):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (B, F, 1, 3))
    dv = rng.uniform(-0.4, 0.4, (B, F, 2, 3))
    fv = np.concatenate([v0, v0 + dv], axis=2).astype(np.float32)
    fv[..., 2] = rng.uniform(5, 15, (B, F, 3))
    return fv


def stacked_triangles():
    """10 stacked triangles, nearest last (test_rasterizer.py:83-90)."""
    tris = [[[-0.9, -0.9, float(z)], [0.9, -0.9, float(z)], [0.0, 0.9, float(z)]]
            for z in [9, 8, 7, 6, 5, 4, 3, 2, 1, 0.5]]
    return np.asarray([tris], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def within_sum(got, want, scale):
    ratio = (T(got).double() - T(want).double()).abs() / (SUM_RTOL * scale.double() + 1e-30)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


@pytest.mark.parametrize("seed,size,F", [(1, 64, 60), (2, 48, 40), (3, 224, 60)])
def test_coverage_jnp_matches_jax(seed, size, F):
    fv = random_mesh(seed, F)
    pt, zt = TR.rasterize_coverage_jnp(T(fv), size)
    pj, zj = JR.rasterize_coverage_jnp(jnp.asarray(fv), size)
    assert pt.dtype == torch.int32 and pt.shape == (2, size, size)
    check_p2f_zbuf(pt, pj, zt, zj, fv, size)
    assert (pt.numpy() >= 0).mean() > 0.1


@pytest.mark.parametrize("seed,size,cap", [(1, 64, 64), (4, 100, 32), (5, 224, 64)])
def test_k8_plain_matches_jax_kernel(seed, size, cap):
    """K8's plain path (rasterize_coverage_pallas) vs the Pallas kernel in
    interpret mode; its tiles walk the same bins in the same order with the
    same arithmetic, so the seeds here agree exactly."""
    fv = random_mesh(seed, 60)
    pt, zt = TR.rasterize_coverage_pallas(T(fv), size, cap)
    pj, zj = JR.rasterize_coverage_pallas(jnp.asarray(fv), size, capacity=cap,
                                          interpret=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    check_p2f_zbuf(pt, pj, zt, zj, fv, size)
    # K8 agrees with the all-pairs raster when no bin overflows
    pa, za = TR.rasterize_coverage_jnp(T(fv), size)
    check_p2f_zbuf(pt, pa, zt, za, fv, size)


def test_k8_capacity_drops_farthest_faces():
    """Capacity 4 of 10 stacked faces: binning keeps the 4 nearest, so the
    nearest (id 9) still wins, in both packages."""
    fv = stacked_triangles()
    pt, _ = TR.rasterize_coverage_pallas(T(fv), 16, 4)
    pj, _ = JR.rasterize_coverage_pallas(jnp.asarray(fv), 16, capacity=4, interpret=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt[0, 8, 8] == 9


def test_k8_plain_walks_count_faces_in_bin_order():
    """raster_bins_coverage_plain equals a sequential strict-< walk of each
    tile's first `count` faces, at a capacity that is not a multiple of 32."""
    fv = random_mesh(6, 50, B=1)
    size, cap = 40, 48
    bins, counts = TR.bin_faces(T(fv), size, cap)
    p2f, zbuf = TR.raster_bins_coverage_plain(counts, bins, T(fv).reshape(1, 50, 9), size)
    c = (2 * np.arange(size, dtype=np.float32) + 1 - size) / np.float32(size)
    f = fv[0]
    for r, col in [(5, 7), (20, 20), (33, 11), (39, 39), (12, 30)]:
        t = (r // 8) * 1 + col // 128
        best, win = np.float32(1e10), -1
        for i in range(int(counts[0, t])):
            fid = int(bins[0, t, i])
            (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = f[fid]
            x, y = c[col], c[r]
            denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
            if abs(denom) < 1e-10:
                continue
            w = [((x1 - x) * (y2 - y) - (y1 - y) * (x2 - x)) / denom,
                 ((x2 - x) * (y0 - y) - (y2 - y) * (x0 - x)) / denom,
                 ((x0 - x) * (y1 - y) - (y0 - y) * (x1 - x)) / denom]
            z = w[0] * z0 + w[1] * z1 + w[2] * z2
            if min(w) >= 0 and z < best:
                best, win = z, fid
        assert int(p2f[0, r, col]) == win, (r, col)
        if win >= 0:
            np.testing.assert_allclose(float(zbuf[0, r, col]), best, rtol=1e-6)


@pytest.mark.parametrize("seed,size,cap", [(1, 64, 64), (7, 100, 96), (8, 32, 32)])
def test_k6_plain_matches_jax_v3_full(seed, size, cap):
    """K6's plain path vs rasterize_coverage_pallas_v3_full (interpret):
    pix_to_face and zbuf by the tie rule, the per-pixel slot and the bins
    equal where pix_to_face agrees; capacity 96 is not a multiple of 128."""
    fv = random_mesh(seed, 60)
    pt, zt, st, bt = TR.rasterize_coverage_pallas_v3_full(T(fv), size, cap)
    pj, zj, sj, bj = JR.rasterize_coverage_pallas_v3_full(jnp.asarray(fv), size,
                                                           capacity=cap, interpret=True)
    check_p2f_zbuf(pt, pj, zt, zj, fv, size)
    agree = pt.numpy() == np.asarray(pj)
    np.testing.assert_array_equal(st.numpy()[agree], np.asarray(sj)[agree])
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert (st.numpy() >= 0).sum() > 0 and int(st.max()) < cap
    p2, z2 = TR.rasterize_coverage_pallas_v3(T(fv), size, cap)
    assert torch.equal(p2, pt) and torch.equal(z2, zt)


def test_rasterize_coverage_dispatch():
    """On the CPU rasterize_coverage is the all-pairs raster, as the JAX
    package's is on its CPU backend."""
    fv = random_mesh(2, 40)
    pt, zt = TR.rasterize_coverage(T(fv), 48)
    pa, za = TR.rasterize_coverage_jnp(T(fv), 48)
    assert torch.equal(pt, pa) and torch.equal(zt, za)
    pj, zj = JR.rasterize_coverage(jnp.asarray(fv), 48)
    check_p2f_zbuf(pt, pj, zt, zj, fv, 48)


@pytest.mark.parametrize("cap,D", [(64, 3), (96, 9)])
def test_k7_plain_matches_jax(cap, D):
    """segment_reduce_tiles (plain: segment_sum) vs the JAX package's Pallas
    kernel on K6's slots, tile-major as the backward feeds it (padding
    pixels carry slot 0), with a random payload of 9 + 3D channels."""
    size = 64
    fv = random_mesh(3, 60)
    _, _, slot_img, _ = TR.rasterize_coverage_pallas_v3_full(T(fv), size, cap)
    slots = TR.image_to_tiles(slot_img, size)
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(JR.image_to_tiles(jnp.asarray(slot_img.numpy()), size)))
    CHN = 9 + 3 * D
    payload = np.random.default_rng(cap).normal(size=tuple(slots.shape) + (CHN,))
    payload = T(payload.astype(np.float32))
    ours = TR.segment_reduce_tiles(slots, payload, cap)
    ref = JR.segment_reduce_tiles(jnp.asarray(slots.numpy()), jnp.asarray(payload.numpy()),
                                  cap, True)
    assert ours.shape == (2, slots.shape[1], cap, CHN)
    within_sum(ours, ref, TR.segment_sum(slots, payload.abs(), cap))
    assert float(ours.abs().sum()) > 0


@pytest.mark.parametrize("D", [3, 9])
def test_interpolate_attributes_fast_matches_jax(D):
    """Values and gradients of interpolate_attributes_fast vs the JAX
    package's on the same pix_to_face / pix_to_slot / bins, and against the
    port's gather-based interpolation."""
    size, cap = 32, 64
    fv = random_mesh(9, 40)
    attr = np.random.default_rng(D).normal(0, 1, (2, 40, 3, D)).astype(np.float32)
    p2f, _, p2slot, bins = JR.rasterize_coverage_pallas_v3_full(
        jnp.asarray(fv), size, capacity=cap, interpret=True)

    def jloss(f, a):
        v, _ = JR.interpolate_attributes_fast(f, a, p2f, p2slot, bins, size, cap, True)
        return jnp.sum(jnp.sin(v) * v), v

    (_, vj), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(fv), jnp.asarray(attr))
    f, a = T(fv).requires_grad_(True), T(attr).requires_grad_(True)
    v, mask = TR.interpolate_attributes_fast(f, a, T(p2f), T(p2slot), T(bins), size, cap)
    assert not mask.requires_grad
    (torch.sin(v) * v).sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gj[0]), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj[1]), **TOL)
    assert float(f.grad[..., 2].abs().max()) == 0.0  # no gradient to z
    f2, a2 = T(fv).requires_grad_(True), T(attr).requires_grad_(True)
    v2, _ = TR.interpolate_attributes(T(p2f), f2, a2)
    (torch.sin(v2) * v2).sum().backward()
    assert torch.equal(v2.detach(), v.detach())
    np.testing.assert_allclose(f.grad.numpy(), f2.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), a2.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D,seed", [(7, 11), (9, 12)])
def test_rasterize_wide_attributes_matches_jax(D, seed):
    """rasterize with D > 6 (K6, then K7 + K5 in the backward) vs the JAX
    package's rasterize(use_pallas=True): values, mask, pix_to_face, zero
    overflow and gradients."""
    size, cap = 32, 64
    fv = random_mesh(seed, 40)
    rng = np.random.default_rng(seed)
    attr = rng.normal(0, 1, (2, 40, 3, D)).astype(np.float32)
    w = rng.normal(size=(2, size, size, D)).astype(np.float32)

    def jloss(f, a):
        v, m, p, o = JR.rasterize(f, a, size, cap, use_pallas=True)
        return (v * w).sum(), (v, m, p, o)

    (_, (vj, mj, pj, oj)), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(fv), jnp.asarray(attr))
    f, a = T(fv).requires_grad_(True), T(attr).requires_grad_(True)
    v, m, p, o = TR.rasterize(f, a, size, cap)
    (v * T(w)).sum().backward()
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    assert o.dtype == torch.int32 and int(o.abs().max()) == 0
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gj[0]), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj[1]), **TOL)
    assert (p.numpy() >= 0).mean() > 0.1 and float(a.grad.abs().sum()) > 0


def test_rasterize_d6_takes_the_planes_path(monkeypatch):
    """D = 6 (13 + 3D = 31 lanes) stays on the planes raster (K3 + K4 + K5):
    K6's and K7's plain versions are never called; D = 7 calls them."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(TR, name, wrapped)

    spy("raster_planes_windows_plain", TR.raster_planes_windows_plain)
    spy("raster_coverage_windows_plain", TR.raster_coverage_windows_plain)
    spy("segment_sum", TR.segment_sum)
    fv = T(random_mesh(5, 30)).requires_grad_(True)
    for D in (6, 7):
        calls.clear()
        attr = torch.ones((2, 30, 3, D), requires_grad=True)
        vals, _, _, _ = TR.rasterize(fv, attr, 32, 32)
        vals.sum().backward()
        want = (["raster_planes_windows_plain", "segment_sum"] if D == 6 else
                ["raster_coverage_windows_plain", "segment_sum"])
        assert calls == want, (D, calls)


def test_segment_moments_large_capacity_matches_jax():
    """D = 6 at capacity 768: K4's accumulators are 768 x 18 x 4 B = 55 KB,
    past the 48 KB a block gets without opt-in. The port's K4 call still
    matches the JAX package's segment_reduce_moments, and `rasterize` at
    that capacity still matches the dense gather-based gradient."""
    size, cap = 32, 768
    rng = np.random.default_rng(13)
    slots = rng.integers(-1, cap, (1, 8, 1024)).astype(np.int32)
    g = rng.normal(size=(1, 8, 1024, 6)).astype(np.float32)
    ours = TR.segment_moments(T(slots), T(g), cap, size)
    ref = JR.segment_reduce_moments(jnp.asarray(slots), jnp.asarray(g), cap, size, True)
    within_sum(ours, ref, TR.segment_sum(T(slots), TR.moment_rows(T(g), size).abs(), cap))

    fv = random_mesh(13, 40, B=1)
    attr = rng.normal(0, 1, (1, 40, 3, 6)).astype(np.float32)
    w = T(rng.normal(size=(1, size, size, 6)).astype(np.float32))
    f, a = T(fv).requires_grad_(True), T(attr).requires_grad_(True)
    v, _, p, _ = TR.rasterize(f, a, size, cap)
    (v * w).sum().backward()
    d_fv, sc_fv, d_at, sc_at = TR.dense_gradient_and_scale(p, T(fv), T(attr), w)
    for got, want, sc in ((f.grad, d_fv, sc_fv), (a.grad, d_at, sc_at)):
        ratio = (got.double() - want.double()).abs() / (1e-4 * sc + 1e-30)
        assert float(ratio.max()) <= 1.0, float(ratio.max())
    assert float(a.grad.abs().sum()) > 0


def test_rasterize_arguments_after_capacity_are_keyword_only():
    """A 5th positional argument (the JAX package's use_pallas) raises
    instead of being read as the compact budget."""
    fv = torch.zeros((1, 4, 3, 3))
    attr = torch.zeros((1, 4, 3, 3))
    with pytest.raises(TypeError):
        TR.rasterize(fv, attr, 32, 32, True)
    vals, _, _, ovf = TR.rasterize(fv, attr, 32, 32, compact=None)
    assert vals.shape == (1, 32, 32, 3) and int(ovf[0]) == 0


def test_bin_faces_dispatch(monkeypatch):
    """bin_faces dispatches on set_bin_mode's mode as the JAX package's
    does: flat by default and under an approximate recall target, sorted
    in the sorted mode, hier in the hier mode where F > 2 x
    COARSE_CAPACITY and the image has more than one band of tiles, and
    flat for a small F in the hier mode (test_rasterizer.py:678). Every
    mode gives the flat bins and counts and no misses here."""
    fv = T(random_mesh(1, 60))
    bins, counts, misses = TR.bin_faces(fv, 64, 64, with_misses=True)
    b2, c2 = TR.bin_faces_flat(fv, 64, 64)
    assert torch.equal(bins, b2) and torch.equal(counts, c2)
    assert misses.dtype == torch.int32 and misses.tolist() == [0, 0]
    bj, cj, mj = JR.bin_faces(jnp.asarray(fv.numpy()), 64, 64, with_misses=True)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cj))
    assert np.asarray(mj).tolist() == [0, 0]
    big = T(random_mesh(2, 2 * TR.COARSE_CAPACITY + 8, B=1) * [0.3, 0.3, 1.0])
    calls = []
    for name in ("bin_faces_flat", "bin_faces_hier", "bin_faces_sorted"):
        def spy(*a, _real=getattr(TR, name), _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(TR, name, spy)
    try:
        for mode, fv_, size, want in (
                ((False, None, False), fv, 64, "bin_faces_flat"),
                ((False, 0.95, False), fv, 64, "bin_faces_flat"),
                ((False, None, True), fv, 64, "bin_faces_sorted"),
                ((True, None, False), fv, 64, "bin_faces_flat"),  # F <= 2 x 1024
                ((True, None, False), big, 32, "bin_faces_flat"),  # one band
                ((True, None, False), big, 64, "bin_faces_hier"),
                ((True, 0.95, True), big, 64, "bin_faces_sorted")):
            TR.set_bin_mode(*mode)
            calls.clear()
            got = TR.bin_faces(fv_, size, 64, with_misses=True)
            assert calls[0] == want, (mode, size, calls)
            TR.set_bin_mode(False)
            want_b, want_c = TR.bin_faces_flat(fv_, size, 64)
            assert torch.equal(got[0], want_b) and torch.equal(got[1], want_c), mode
            assert got[2].tolist() == [0] * fv_.shape[0], mode
        got = TR.bin_faces(fv, 64, 64, approx=0.95)
        assert torch.equal(got[0], b2) and torch.equal(got[1], c2)
    finally:
        TR.set_bin_mode(False)
