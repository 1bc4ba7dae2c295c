"""PyTorch port vs the JAX package: binning, the compact plan, the chunk
compaction (K2), the fused z-buffer (K1, compact and padded layouts) and
`Renderer.render_inference`.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances. Bins, counts, plans, packed chunks and overflow must be equal;
the port's exact binning must miss no face (the JAX package counts misses
of its approximate top-k). pix_to_face must be equal except at pixels that are shown to be an
edge or a depth tie of the two candidate faces; those are counted and
bounded (at most 0.1 % of pixels). Depth and normals are held to the
rounding bound of their fp32 evaluation from the face vertices, 8u times
the sum of the magnitudes rounded (u = 2^-24, see `_interp`), not to a
fixed epsilon: XLA on the CPU contracts `a*x + b*y` into fused
multiply-adds inside the jitted raster (checked: XLA evaluates
fma(a, x, round(b*y)) + c and jnp.mean over 3 as a sum times 1/3), while
the port rounds every product, as its CUDA kernel must to stay bitwise
equal to the plain version on the card. The record planes of small
triangles cancel large terms (depth is built around z ~ 10 from
differences of ~1e-4 areas), so at 224 px the two packages' depths differ
by up to ~3e-3 and their normals by up to ~2e-4, inside that bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu.render.renderer import Renderer as JaxRenderer
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as TR
from smirk_tpu_torch.render.renderer import Renderer
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

U = 2.0 ** -24
ROUNDING = 8 * U
MAX_MISMATCH_SHARE = 1e-3


@pytest.fixture(scope="module")
def bundles():
    return {False: procedural_bundle(seed=1, full_size=False),
            True: procedural_bundle(seed=1, full_size=True)}


def make_scene(bundle, size, B, seed, compact=None):
    """Jittered head at a random cam around scale 7 -> (renderer, verts,
    cam, face_verts, face_normals), all on the CPU."""
    rng = np.random.default_rng(seed)
    vt = bundle["v_template"]
    verts = (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32)
    cam = np.stack([rng.uniform(6.0, 8.0, B), rng.uniform(-0.05, 0.05, B),
                    rng.uniform(-0.05, 0.05, B)], 1).astype(np.float32)
    r = Renderer(bundle, image_size=size, raster_compact=compact, device="cpu")
    v, c = torch.from_numpy(verts), torch.from_numpy(cam)
    fv, fn = r._face_geometry(v, r.project(v, c))
    return r, verts, cam, fv, fn


def _centres(size):
    i = np.arange(size, dtype=np.float64)
    c = (2.0 * i + 1.0 - size) / size
    return c[None, :], c[:, None]


def _interp(fv, attr, x, y):
    """Exact (float64) edge functions and barycentric interpolation of
    per-corner values at pixel centres, with their rounding scales.

    fv (...,3,3) face vertices, attr (...,3) per-corner values, x/y
    broadcastable to fv[..., 0, 0]. -> (e (...,3), S_e (...,3), value,
    S_value): S_e = |a x| + |b y| + |x_j y_k| + |y_j x_k| bounds the terms
    an fp32 evaluation of edge i rounds, S_value = sum_i S_e,i |attr_i| /
    |denom| + |value| those of the interpolated value."""
    fv = np.asarray(fv, np.float64)
    X, Y = fv[..., 0], fv[..., 1]
    es, ss = [], []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        a, b = Y[..., j] - Y[..., k], X[..., k] - X[..., j]
        p, q = X[..., j] * Y[..., k], Y[..., j] * X[..., k]
        es.append(a * x + b * y + p - q)
        ss.append(np.abs(a * x) + np.abs(b * y) + np.abs(p) + np.abs(q))
    e, s = np.stack(es, -1), np.stack(ss, -1)
    denom = e.sum(-1)
    safe = np.where(denom == 0, 1.0, denom)
    attr = np.asarray(attr, np.float64)
    value = (e * attr).sum(-1) / safe
    return e, s, value, (s * np.abs(attr)).sum(-1) / np.abs(safe) + np.abs(value)


def _winner_fields(fv, attr, p2f, size):
    """_interp of each pixel's face p2f (clamped at 0) -> (value, scale)."""
    X, Y = _centres(size)
    b = np.arange(p2f.shape[0])[:, None, None]
    f = np.maximum(p2f, 0)
    _, _, v, s = _interp(np.asarray(fv)[b, f], np.asarray(attr)[b, f], X, Y)
    return v, s


def check_p2f_zbuf(p2f_a, p2f_b, zb_a, zb_b, face_verts, size):
    """Equal pix_to_face, except pixels where the two candidate faces are
    an edge or a depth tie within rounding; zbuf equal where uncovered and
    within rounding of the winner's depth where covered. -> mismatch count."""
    p2f_a, p2f_b = np.asarray(p2f_a), np.asarray(p2f_b)
    zb_a, zb_b = np.asarray(zb_a), np.asarray(zb_b)
    fv = np.asarray(face_verts, np.float64)
    same = p2f_a == p2f_b
    cov = same & (p2f_a >= 0)
    np.testing.assert_array_equal(zb_a[same & ~cov], zb_b[same & ~cov])
    _, zs = _winner_fields(fv, fv[..., 2], p2f_a, size)
    zerr = np.abs(zb_a.astype(np.float64) - zb_b)
    assert (zerr[cov] <= ROUNDING * zs[cov]).all(), zerr[cov].max()
    X, Y = _centres(size)
    bad = np.argwhere(~same)
    for b, r, c in bad:
        faces = [f for f in (p2f_a[b, r, c], p2f_b[b, r, c]) if f >= 0]
        terms = [_interp(fv[b, f], fv[b, f, :, 2], X[0, c], Y[r, 0]) for f in faces]
        # an edge of a candidate passes through the pixel centre ...
        tie = any((np.abs(e) <= ROUNDING * s).any() for e, s, _, _ in terms)
        if len(faces) == 2:  # ... or both are there at equal depth
            (_, _, za, sa), (_, _, zb, sb) = terms
            tie |= abs(za - zb) <= ROUNDING * (sa + sb)
        assert tie, f"pixel {(b, r, c)}: faces {faces} differ without an edge or z tie"
    assert len(bad) <= MAX_MISMATCH_SHARE * p2f_a.size, len(bad)
    return len(bad)


def check_normals(n_a, n_b, p2f, face_verts, face_normals, size):
    """Normals equal where uncovered, within rounding of the winner's
    interpolated normal where covered (p2f = -1 marks pixels to skip)."""
    n_a, n_b, p2f = np.asarray(n_a), np.asarray(n_b), np.asarray(p2f)
    cov = p2f >= 0
    fn = np.asarray(face_normals, np.float64)
    for d in range(3):
        _, s = _winner_fields(face_verts, fn[..., d], p2f, size)
        err = np.abs(n_a[..., d].astype(np.float64) - n_b[..., d])
        assert (err[cov] <= ROUNDING * s[cov]).all(), (d, err[cov].max())
    return cov


SCENES = [(False, 64, 2, 0), (True, 224, 1, 1)]


@pytest.mark.parametrize("full,size,B,seed", SCENES)
def test_binning_and_compact_plan_exact(bundles, full, size, B, seed):
    r, _, _, fv, _ = make_scene(bundles[full], size, B, seed)
    fvj = jnp.asarray(fv.numpy())
    cap = r.bin_capacity
    bt, ct = TR.bin_faces_flat(fv, size, cap)
    for approx in (None, 0.95):  # the JAX renderer bins with approx_max_k
        bj, cj, mj = JR.bin_faces_flat(fvj, size, cap, approx, with_misses=True)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert int(np.asarray(mj).sum()) == 0
    # no selection misses: at a capacity past the face count every
    # overlapping face is kept, and each tile keeps min(that, capacity)
    F = fv.shape[1]
    _, pre = TR.bin_faces_flat(fv, size, -(-F // 32) * 32)
    np.testing.assert_array_equal(ct.numpy(), pre.clamp(max=min(cap, F)).numpy())
    assert (ct.numpy() > 0).any()
    for budget in (r.raster_compact, 8):
        st, et, tt, tot, dt = TR._compact_plan(ct, budget)
        sj, ej, tj, metaj, dj = JR._compact_plan(jnp.asarray(ct.numpy()), budget)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(tot.numpy(), np.asarray(metaj)[:, 0])
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int(dt.min()) > 0  # budget 8 overflows


@pytest.mark.parametrize("full,size,B,seed", SCENES)
def test_compact_faces_plain_matches_jax_kernel(bundles, full, size, B, seed):
    r, _, _, fv, _ = make_scene(bundles[full], size, B, seed)
    cap = r.bin_capacity
    CPT = cap // TR.V3_CHUNK
    bins, counts = TR.bin_faces_flat(fv, size, cap)
    Tp = bins.shape[1]
    for budget in (r.raster_compact, 8):
        st, _, tt, tot, _ = TR._compact_plan(counts, budget)
        ours = TR.compact_faces_plain(tt, st, tot, bins.reshape(B, Tp * CPT, 32), CPT)
        sj, _, tj, metaj, _ = JR._compact_plan(jnp.asarray(counts.numpy()), budget)
        ref = JR._compact_faces(metaj, tj, sj, jnp.asarray(bins.numpy()), B, Tp,
                                CPT, budget, True)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert (ours.numpy() >= 0).sum() > 0


FUSED_CASES = [
    (False, 64, 2, 2, "auto"), (False, 64, 2, 2, None), (False, 64, 2, 2, 8),
    # 100 px: a partial last tile row and column, and padding tiles (13 -> 16)
    (False, 100, 2, 5, "auto"),
    (True, 224, 1, 3, "auto"), (True, 224, 1, 3, 24),
]


@pytest.mark.parametrize("full,size,B,seed,compact", FUSED_CASES)
def test_fused_raster_matches_jax(bundles, full, size, B, seed, compact):
    """K1 (+K2) plain vs rasterize_normals_fused on the same face geometry:
    compact layout at the auto budget, padded layout (compact=None), and a
    truncated budget whose trailing tiles render empty."""
    r, _, _, fv, fn = make_scene(bundles[full], size, B, seed)
    if compact == "auto":
        compact = r.raster_compact
    cap = r.bin_capacity
    nt, pt, zt, ot = TR.rasterize_normals_fused(
        fv, fn, size, capacity=cap, compact=compact, return_overflow=True)
    nj, pj, zj, oj = JR.rasterize_normals_fused(
        jnp.asarray(fv.numpy()), jnp.asarray(fn.numpy()), size, capacity=cap,
        interpret=True, compact=compact, return_overflow=True, bin_approx=0.95,
        bin_miss_check=True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    n_bad = check_p2f_zbuf(pt, pj, zt, zj, fv, size)
    agree = pt.numpy() == np.asarray(pj)
    cov = check_normals(nt, nj, np.where(agree, pt.numpy(), -1), fv, fn, size)
    np.testing.assert_array_equal(nt.numpy()[~cov & agree], np.asarray(nj)[~cov & agree])
    print(f"pix_to_face mismatches (edge/z ties): {n_bad}; max |dz| "
          f"{np.abs(zt.numpy() - np.asarray(zj))[agree].max():.3g}, max |dn| "
          f"{np.abs(nt.numpy() - np.asarray(nj))[agree].max():.3g}")
    covered = (pt.numpy() >= 0).mean()
    assert covered > 0.05
    if compact is not None and compact < r.raster_compact:
        assert int(ot.min()) > 0
        full_n, full_p, _ = TR.rasterize_normals_fused(fv, fn, size, capacity=cap)
        assert (pt.numpy() >= 0).sum() < (full_p.numpy() >= 0).sum()
        kept = pt.numpy() >= 0
        np.testing.assert_array_equal(pt.numpy()[kept], full_p.numpy()[kept])


def test_degenerate_and_mixed_winding_faces():
    """Zero-area faces never cover a pixel; both windings rasterize; the
    port and JAX agree on every output."""
    rng = np.random.default_rng(8)
    F = 40
    fv = np.concatenate([rng.uniform(-0.9, 0.9, (1, F, 3, 2)),
                         rng.uniform(10.2, 10.8, (1, F, 3, 1))], -1).astype(np.float32)
    fv[0, :5, 2] = fv[0, :5, 1]  # repeated vertex
    fv[0, 5:10, 2, :2] = 2 * fv[0, 5:10, 1, :2] - fv[0, 5:10, 0, :2]  # collinear
    fn = rng.normal(0, 1, (1, F, 3, 3)).astype(np.float32)
    for compact in (None, 64):
        nt, pt, zt = TR.rasterize_normals_fused(
            torch.from_numpy(fv), torch.from_numpy(fn), 48, capacity=64, compact=compact)
        nj, pj, zj = JR.rasterize_normals_fused(
            jnp.asarray(fv), jnp.asarray(fn), 48, capacity=64, interpret=True,
            compact=compact)
        assert check_p2f_zbuf(pt, pj, zt, zj, fv, 48) <= 2
        agree = pt.numpy() == np.asarray(pj)
        check_normals(nt, nj, np.where(agree, pt.numpy(), -1), fv, fn, 48)
        assert not np.isin(pt.numpy(), np.arange(10)).any()
        assert (pt.numpy() >= 10).mean() > 0.3


def test_tie_break_keeps_first_slot():
    """Two coincident triangles (ids 0 and 1, same depth) and a nearer
    small one: ties go to the earlier slot in near-to-far bin order, here
    face 0, in both packages and both layouts."""
    tri = [[-0.8, -0.8, 10.5], [0.8, -0.8, 10.5], [0.0, 0.8, 10.5]]
    near = [[-0.2, -0.2, 10.2], [0.2, -0.2, 10.2], [0.0, 0.2, 10.2]]
    fv = np.asarray([[tri, tri, near]], np.float32)
    fn = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (1, 3, 3, 1))
    for compact in (None, 16):
        _, pt, zt = TR.rasterize_normals_fused(
            torch.from_numpy(fv), torch.from_numpy(fn), 32, capacity=32, compact=compact)
        _, pj, zj = JR.rasterize_normals_fused(
            jnp.asarray(fv), jnp.asarray(fn), 32, capacity=32, interpret=True,
            compact=compact)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        assert check_p2f_zbuf(pt, pj, zt, zj, fv, 32) == 0
        assert set(np.unique(pt.numpy())) == {-1, 0, 2}


@pytest.mark.parametrize("full,size,B,seed", SCENES)
def test_render_inference_matches_jax(bundles, full, size, B, seed):
    bundle = bundles[full]
    r, verts, cam, _, _ = make_scene(bundle, size, B, seed)
    jr = JaxRenderer(bundle, image_size=size, use_pallas=True)
    assert (r.bin_capacity, r.raster_compact) == (jr.bin_capacity, jr.raster_compact)
    lmk = {"landmarks_fan": np.random.default_rng(0).normal(0, 0.05, (B, 68, 3))
           .astype(np.float32)}
    ref = jr(jnp.asarray(verts), jnp.asarray(cam),
             {k: jnp.asarray(v) for k, v in lmk.items()}, inference=True)
    out = r(torch.from_numpy(verts), torch.from_numpy(cam),
            {k: torch.from_numpy(v) for k, v in lmk.items()}, inference=True)
    assert set(out) == set(ref)
    for k in ("transformed_vertices", "landmarks_fan", "raster_overflow"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    p2f, pj = out["pix_to_face"].numpy(), np.asarray(ref["pix_to_face"])
    tv = torch.from_numpy(np.array(ref["transformed_vertices"]))
    fv, fn = r._face_geometry(torch.from_numpy(verts), tv)
    zero = np.zeros(p2f.shape, np.float32)
    n_bad = check_p2f_zbuf(p2f, pj, zero, zero, fv, size)
    agree = p2f == pj
    np.testing.assert_array_equal(out["rendered_mask"].numpy()[agree],
                                  np.asarray(ref["rendered_mask"])[agree])
    # shading is 1.7 * gray * mean over lights of clamp(n . dir): a normal
    # error within its bound moves the render by at most 1.7 * gray * |dn|
    n_bound = np.zeros(p2f.shape)
    for d in range(3):
        n_bound += (ROUNDING * _winner_fields(fv, fn[..., d], p2f, size)[1]) ** 2
    bound = 1.7 * (180.0 / 255.0) * np.sqrt(n_bound) + 1e-6
    err = np.abs(out["rendered_img"].numpy() - np.asarray(ref["rendered_img"])).max(-1)
    assert (err[agree] <= bound[agree]).all(), err[agree].max()
    print(f"pix_to_face mismatches (edge/z ties): {n_bad}; max render diff "
          f"{err[agree].max():.3g}")
    assert out["rendered_mask"].numpy().mean() > 0.05
    occ, occ_j = (x.measure_compact_occupancy(v, c) for x, v, c in (
        (r, torch.from_numpy(verts), torch.from_numpy(cam)),
        (jr, jnp.asarray(verts), jnp.asarray(cam))))
    assert occ == occ_j and occ["occupied_chunks"] <= occ["budget"]


def test_renderer_sizes_and_env(bundles, monkeypatch):
    """Auto capacity/budget equal the JAX renderer's (384 / 216 at 224 px
    on the 3408-face region); env flags read as set/unset, '0' = off."""
    full = bundles[True]
    r = Renderer(full, image_size=224, device="cpu")
    assert (r.bin_capacity, r.raster_compact) == (384, 216)
    monkeypatch.setenv("SMIRK_RASTER_COMPACT", "0")
    r0 = Renderer(full, image_size=224, device="cpu")
    assert r0.raster_compact == 0
    monkeypatch.setenv("SMIRK_RASTER_COMPACT", "")
    r1 = Renderer(full, image_size=224, device="cpu")
    assert r1.raster_compact == 216
    # inference=False is the differentiable render: the inference render's
    # keys and pixels, and an image that carries a gradient to the vertices
    v = torch.from_numpy(np.array(full["v_template"][None])).requires_grad_(True)
    cam = torch.tensor([[7.0, 0.0, 0.0]])
    out = r1(v, cam)
    ref = r1(v.detach(), cam, inference=True)
    assert set(out) == set(ref)
    assert out["rendered_img"].requires_grad and not ref["rendered_img"].requires_grad
    assert (out["pix_to_face"] == ref["pix_to_face"]).float().mean() > 0.999
    assert float(out["rendered_mask"].mean()) > 0.05
    out["rendered_img"].sum().backward()
    assert float(v.grad.abs().sum()) > 0
