"""PyTorch port vs the JAX package: the binning modes (hierarchical,
sort-based, approximate), the selection-miss check on the rasters'
overflow, the fold modes and the Renderer's binning arguments.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode); its binning globals are set only through monkeypatch on
`_BIN_HIER`, `_BIN_APPROX` and `_BIN_SORTED`, and its fold mode on
`_FOLD_MODE` (a jitted JAX function bakes them when it traces). The
approximate selection is `jax.lax.approx_max_k` in the JAX package, which
XLA lowers to an exact top-k on the CPU, and `rasterizer.approx_max_k`
(exact) in the port; a lossy selector is injected on both sides to make
misses.

Tolerances. Bins, counts, misses and overflow are integers: equal. The
fold modes reorder fp32 sums: every element within 1e-5 x the sum of the
magnitudes of its terms, and for "cumsum", whose totals are differences
of prefix sums, 1e-5 x the sum of the magnitudes of every row up to the
face's run's end in its image (the terms the two prefix sums round).
Renders and gradients under a mode that leaves the arithmetic alone
(arming the miss check, an exact binning mode): bitwise.
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
from smirk_tpu_torch.render.renderer import Renderer
from test_torch_raster import make_scene
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

SUM_RTOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def random_mesh(seed, F=40, B=2):
    """tests/test_rasterizer.py's random_mesh."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (B, F, 1, 3))
    dv = rng.uniform(-0.4, 0.4, (B, F, 2, 3))
    fv = np.concatenate([v0, v0 + dv], axis=2).astype(np.float32)
    fv[..., 2] = rng.uniform(5, 15, (B, F, 3))
    return fv


def facelike_scene(seed, B=2, F=3408, spread=0.7, tri=0.03):
    """tests/test_rasterizer.py's _facelike_scene: F small triangles."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (B, F, 1, 2))
    xy = c + rng.uniform(-tri, tri, (B, F, 3, 2))
    z = rng.uniform(9.5, 10.5, (B, F, 1, 1)) + rng.uniform(-0.01, 0.01, (B, F, 3, 1))
    return np.concatenate([xy, np.broadcast_to(z, (B, F, 3, 1))], -1).astype(np.float32)


def assert_same(port, jax_out):
    assert len(port) == len(jax_out)
    for a, b in zip(port, jax_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def lossy_torch(x, k, recall_target=None):
    vals, idx = torch.topk(x, k, dim=-1)
    vals = vals.clone()
    vals[..., 0] = -1.0  # the best entry "missed"
    return vals, idx


def lossy_jax(keyf, k, recall_target=None, **kw):
    vals, idx = jax.lax.top_k(keyf, k)
    return vals.at[..., 0].set(-1.0), idx


@pytest.fixture(scope="module")
def head():
    """The procedural head's face region at B=2, 224 px."""
    return make_scene(procedural_bundle(seed=1, full_size=True), 224, 2, 7)[3]


def test_hier_matches_jax_and_flat(head):
    """bin_faces_hier, exact and at approx 0.95, against the JAX package's
    and the port's flat binning, bitwise, with misses: F small triangles at
    capacity 64 and 384, a dense scene that overflows the coarse list, and
    the head (test_rasterizer.py:643, :662)."""
    scenes = [(T(facelike_scene(3)), (64, 384)),
              (T(facelike_scene(4, spread=0.05, tri=0.01)), (384,)),
              (head, (384,))]
    for fv, caps in scenes:
        fvj = jnp.asarray(fv.numpy())
        for cap in caps:
            flat = TR.bin_faces_flat(fv, 224, cap)
            for approx in (None, 0.95):
                got = TR.bin_faces_hier(fv, 224, cap, approx=approx, with_misses=True)
                want = JR.bin_faces_hier(fvj, 224, cap, approx=approx, with_misses=True)
                assert_same(got, want)
                assert torch.equal(got[0], flat[0]) and torch.equal(got[1], flat[1])
                assert got[2].tolist() == [0, 0]
    # a coarse list shorter than the band's faces, capacity past it (the
    # JAX test's approx-on-hier case, :744)
    fv = T(np.random.default_rng(1).normal(0, 0.4, (1, 700, 3, 3)).astype(np.float32))
    for approx in (None, 0.95):
        got = TR.bin_faces_hier(fv, 64, 64, coarse_capacity=256, approx=approx,
                                with_misses=True)
        assert_same(got, JR.bin_faces_hier(jnp.asarray(fv.numpy()), 64, 64,
                                           coarse_capacity=256, approx=approx,
                                           with_misses=True))


def test_sorted_matches_jax(head):
    """bin_faces_sorted against the JAX package's and the port's exact flat
    binning (test_rasterizer.py:804), capacity overflow and off-screen
    faces included; a tall face clipped to one tile row, whose dropped
    incidences are its misses (:830)."""
    cases = [(T(random_mesh(41 + i, F)), size, cap)
             for i, (F, size, cap) in enumerate(((120, 32, 64), (300, 64, 96),
                                                 (120, 32, 32), (200, 100, 64)))]
    cases.append((head, 224, 384))
    for fv, size, cap in cases:
        got = TR.bin_faces_sorted(fv, size, cap, with_misses=True)
        assert_same(got, JR.bin_faces_sorted(jnp.asarray(fv.numpy()), size, cap,
                                             with_misses=True))
        flat = TR.bin_faces_flat(fv, size, cap)
        assert torch.equal(got[0], flat[0]) and torch.equal(got[1], flat[1])
        assert got[2].tolist() == [0] * fv.shape[0]
    off = random_mesh(5, 8, B=1)
    off[..., 1] += 4.0  # below the screen
    got = TR.bin_faces_sorted(T(off), 32, 16, with_misses=True)
    assert int(got[1].sum()) == 0 and got[2].tolist() == [0]
    tall = T(np.asarray([[[[-0.1, -0.9, 5.0], [0.1, -0.9, 5.0], [0.0, 0.9, 5.0]]]],
                        np.float32))
    _, cfull = TR.bin_faces_sorted(tall, 32, 16, max_row_span=8)
    assert int(cfull.sum()) >= 3
    got = TR.bin_faces_sorted(tall, 32, 16, max_row_span=1, with_misses=True)
    assert_same(got, JR.bin_faces_sorted(jnp.asarray(tall.numpy()), 32, 16,
                                         max_row_span=1, with_misses=True))
    assert int(got[2][0]) == int(cfull.sum()) - int(got[1].sum()) > 0


def test_selection_misses_and_lossy_selector(monkeypatch):
    """selection_misses' arithmetic (test_rasterizer.py:768); then a lossy
    selector (each tile's best face dropped) injected on both sides: the
    misses of bin_faces_flat and bin_faces_hier, and the overflow of
    rasterize_planes_diff and rasterize_normals_fused with the check armed,
    equal the JAX package's (one a non-empty tile for flat, :844), and 0
    with it disarmed; bin_miss_check without return_overflow raises
    (:976)."""
    pre = np.asarray([[5, 2, 0, 9], [0, 0, 0, 0]], np.int32)
    counts = np.asarray([[3, 2, 0, 8], [0, 0, 0, 0]], np.int32)
    got = TR.selection_misses(T(pre), T(counts), 8)
    assert got.dtype == torch.int32 and got.tolist() == [2, 0]
    assert np.asarray(JR.selection_misses(jnp.asarray(pre), jnp.asarray(counts), 8)).tolist() \
        == [2, 0]

    fvn = random_mesh(29, 61)
    fv, fvj = T(fvn), jnp.asarray(fvn)
    rng = np.random.default_rng(30)
    attr = rng.normal(0, 1, (2, 61, 3, 3)).astype(np.float32)
    size, cap = 32, 64
    _, counts_exact, miss0 = TR.bin_faces_flat(fv, size, cap, with_misses=True)
    assert miss0.tolist() == [0, 0]
    expected = (counts_exact > 0).sum(1)
    assert (expected > 0).all()
    budget = 2 * int(((counts_exact + 31) // 32).sum(1).max())
    monkeypatch.setattr(TR, "approx_max_k", lossy_torch)
    monkeypatch.setattr(jax.lax, "approx_max_k", lossy_jax)
    got = TR.bin_faces_flat(fv, size, cap, approx=0.9, with_misses=True)
    assert_same(got, JR.bin_faces_flat(fvj, size, cap, approx=0.9, with_misses=True))
    assert torch.equal(got[2], expected.to(torch.int32))
    fvh = random_mesh(31, 700, B=1) * np.float32([0.4, 0.4, 1.0])
    got = TR.bin_faces_hier(T(fvh), 64, 64, coarse_capacity=256, approx=0.9,
                            with_misses=True)
    assert_same(got, JR.bin_faces_hier(jnp.asarray(fvh), 64, 64, coarse_capacity=256,
                                       approx=0.9, with_misses=True))
    assert int(got[2][0]) > 0
    for check in (False, True):
        ovf = TR.rasterize_planes_diff(fv, T(attr), size, cap, compact=budget,
                                       bin_approx=0.9, bin_miss_check=check)[3]
        ovj = JR.rasterize_planes_diff(fvj, jnp.asarray(attr), size, cap, True, budget,
                                       0.9, check)[3]
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovj))
        assert ovf.tolist() == (expected.tolist() if check else [0, 0])
    fn = rng.normal(0, 1, (2, 61, 3, 3)).astype(np.float32)
    for compact in (budget, None):
        ovf = TR.rasterize_normals_fused(fv, T(fn), size, cap, compact=compact,
                                         bin_approx=0.9, return_overflow=True,
                                         bin_miss_check=True)[3]
        ovj = JR.rasterize_normals_fused(fvj, jnp.asarray(fn), size, capacity=cap,
                                         interpret=True, compact=compact, bin_approx=0.9,
                                         return_overflow=True, bin_miss_check=True)[3]
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovj))
        assert torch.equal(ovf, expected.to(torch.int32))
    with pytest.raises(ValueError, match="return_overflow"):
        TR.rasterize_normals_fused(fv, T(fn), size, cap, bin_approx=0.95,
                                   bin_miss_check=True)


def within(got, want, scale, rtol=SUM_RTOL):
    err = (got.double() - torch.tensor(np.asarray(want)).double()).abs()
    ratio = float((err / (rtol * scale + 1e-30)).max())
    assert ratio <= 1.0, ratio


def test_fold_modes_match_jax(monkeypatch):
    """fold_slots_to_faces in each of the four modes against the JAX
    package's in the same mode (matmul: its Pallas fold in interpret mode)
    and against the plain fold, on per-slot rows of mixed signs with empty
    and out-of-range slots; then the gradients of rasterize_planes_diff
    (the training backward: K4's store and the mode's fold outside
    "matmul") and of rasterize at D = 9 (the op path's: K7, then the fold)
    in each mode against "matmul", within 1e-4 x the rounding scale of
    `dense_gradient_and_scale` (tests/test_torch_raster_diff.py's rule)."""
    rng = np.random.default_rng(11)
    B, Tp, C, CHN, F = 2, 8, 64, 9, 300
    per_slot = rng.normal(0, 1, (B, Tp, C, CHN)).astype(np.float32)
    bins = rng.integers(-1, F, (B, Tp, C)).astype(np.int32)
    bins[0, 0, :5] = F + 3  # out of range: dropped
    ps, bt = T(per_slot), T(bins)
    plain = TR.fold_slots_to_faces_plain(ps, bt, F)
    mag = TR.fold_slots_to_faces_plain(ps.abs(), bt, F).double()
    # the JAX package's cumsum differences fp32 prefix sums, each within
    # n u of the magnitudes of the n rows it sums (a recursive sum's bound)
    prefix = torch.cumsum(mag, dim=1) * (Tp * C * 2.0 ** -24 / SUM_RTOL)
    r, _, _, fv, fn = make_scene(procedural_bundle(seed=1, full_size=False), 64, 2, 3)
    g = T(rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32))
    g9 = T(rng.normal(0, 1, (2, 64, 64, 9)).astype(np.float32))
    attr9 = torch.cat([fn, fn * 0.5, fv], -1)
    grads = {}
    try:
        for mode in TR.FOLD_MODES:
            TR.set_fold_mode(mode)
            monkeypatch.setattr(JR, "_FOLD_MODE", mode)
            got = TR.fold_slots_to_faces(ps, bt, F)
            want = JR.fold_slots_to_faces(jnp.asarray(per_slot), jnp.asarray(bins), F, True)
            within(got, want, mag + (prefix if mode == "cumsum" else 0))
            within(got, plain, mag)
            a, n = fv.clone().requires_grad_(True), fn.clone().requires_grad_(True)
            vals, _, p2f, _ = TR.rasterize_planes_diff(a, n, 64, r.bin_capacity,
                                                       compact=r.raster_compact)
            grads[mode] = torch.autograd.grad((vals * g).sum(), (a, n))
            a9 = attr9.clone().requires_grad_(True)
            vals9, _, p9, _ = TR.rasterize(fv, a9, 64, 512)
            grads[mode] += torch.autograd.grad((vals9 * g9).sum(), (a9,))
        with pytest.raises(ValueError, match="fold mode"):
            TR.set_fold_mode("onehot")
    finally:
        TR.set_fold_mode("matmul")
    _, sc_fv, _, sc_fn = TR.dense_gradient_and_scale(p2f, fv, fn, g)
    _, _, _, sc_9 = TR.dense_gradient_and_scale(p9, fv, attr9, g9, weighted=False)
    for mode in TR.FOLD_MODES[1:]:  # against "matmul"
        for got, want, sc in zip(grads[mode], grads["matmul"], (sc_fv, sc_fn, sc_9)):
            within(got, want, sc, rtol=1e-4)
        # on the CPU "scatter" is the plain fold's index_add_, and a stable
        # sort keeps each face's rows in order
        if mode != "cumsum":
            assert all(torch.equal(a, b) for a, b in zip(grads[mode], grads["matmul"]))
    assert float(grads["matmul"][2].abs().sum()) > 0


def test_renderer_flags_env_and_modes(monkeypatch):
    """The Renderer's binning arguments and environment variables against
    the JAX package's Renderer (test_rasterizer.py:915-975, on the
    procedural head); a JAX-style positional call and use_pallas raise
    TypeError; armed and disarmed renders of both paths are bitwise equal
    with raster_overflow 0; set_bin_mode reaches both render paths (the
    same renders); a lossy selector shows in the default renderer's
    raster_overflow on both paths (:987)."""
    bundle = procedural_bundle(seed=2, full_size=True)  # F > 2 x COARSE_CAPACITY

    def both(**kw):
        t = Renderer(bundle, device="cpu", **kw)
        j = JaxRenderer(bundle, use_pallas=True, **kw)
        for attr in ("bin_approx", "diff_bin_approx", "bin_miss_check_diff",
                     "bin_miss_check_fused"):
            assert getattr(t, attr) == getattr(j, attr), (kw, attr)
        return t

    monkeypatch.delenv("SMIRK_BIN_MISS_CHECK", raising=False)
    monkeypatch.delenv("SMIRK_DIFF_BIN_EXACT", raising=False)
    base = both()
    assert base.bin_approx == base.diff_bin_approx == 0.95
    assert base.bin_miss_check_diff and base.bin_miss_check_fused
    assert not both(diff_bin_approx=None).bin_miss_check_diff
    assert not both(bin_approx=None).bin_miss_check_fused
    assert not both(bin_miss_check=False).bin_miss_check_fused
    monkeypatch.setenv("SMIRK_DIFF_BIN_EXACT", "1")
    exact = both()
    assert exact.diff_bin_approx is None and not exact.bin_miss_check_diff
    monkeypatch.setenv("SMIRK_DIFF_BIN_EXACT", "")
    assert both().diff_bin_approx == 0.95
    monkeypatch.delenv("SMIRK_DIFF_BIN_EXACT")
    for env, armed in (("0", False), ("1", True), ("", True)):
        monkeypatch.setenv("SMIRK_BIN_MISS_CHECK", env)
        r = both()
        assert r.bin_miss_check_diff == r.bin_miss_check_fused == armed, env
    monkeypatch.setenv("SMIRK_BIN_MISS_CHECK", "0")
    disarmed = both()
    monkeypatch.delenv("SMIRK_BIN_MISS_CHECK")
    for jax_style in ((False, 224, None, True), (False, 224, None, None, 216)):
        with pytest.raises(TypeError):
            Renderer(bundle, *jax_style)
    with pytest.raises(TypeError):
        Renderer(bundle, image_size=64, use_pallas=True, device="cpu")

    vt = bundle["v_template"]
    rng = np.random.default_rng(5)
    verts = T((vt[None] + rng.normal(0, 3e-4, (1,) + vt.shape)).astype(np.float32))
    c = vt[base.kept_vertices].mean(0)
    cam = T(np.asarray([[7.0, -c[0], -c[1]]], np.float32))
    outs = {}
    for inference in (False, True):
        a = base(verts, cam, inference=inference)
        b = disarmed(verts, cam, inference=inference)
        assert a["raster_overflow"].tolist() == [0] == b["raster_overflow"].tolist()
        assert torch.equal(a["rendered_img"], b["rendered_img"])
        assert float(a["rendered_mask"].mean()) > 0.05
        outs[inference] = a

    calls = []
    for name in ("bin_faces_hier", "bin_faces_sorted"):
        def spy(*a, _real=getattr(TR, name), _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(TR, name, spy)
    try:
        for mode, want in (((False, None, True), "bin_faces_sorted"),
                           ((True, None, False), "bin_faces_hier")):
            TR.set_bin_mode(*mode)
            for inference in (False, True):
                calls.clear()
                res = base(verts, cam, inference=inference)
                assert calls == [want], (mode, inference, calls)
                assert torch.equal(res["rendered_img"], outs[inference]["rendered_img"])
                assert res["raster_overflow"].tolist() == [0]
    finally:
        TR.set_bin_mode(False)

    monkeypatch.setattr(TR, "approx_max_k", lossy_torch)
    for inference in (False, True):
        assert int(base(verts, cam, inference=inference)["raster_overflow"].sum()) > 0
