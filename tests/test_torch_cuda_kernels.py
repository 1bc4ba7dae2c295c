"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; on a machine without a card they
skip. They import no JAX, so they run on the card's machine with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("full,size,B", [(False, 64, 2), (False, 100, 2), (True, 224, 3)])
def test_kernels_match_plain(card, full, size, B):
    bundle = procedural_bundle(seed=2, full_size=full)
    rng = np.random.default_rng(0)
    vt = bundle["v_template"]
    verts = torch.from_numpy(
        (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32)).to(card)
    cam = torch.tensor([[7.0, 0.0, 0.0]] * B, device=card)
    r = Renderer(bundle, image_size=size, device=card)
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    cap = r.bin_capacity
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    records = R.fused_records(fv, fn)
    R.reset_launch_counts()
    for compact in (r.raster_compact, 8, None):
        kept, overflow = R._windows(counts, compact)
        got = R.raster_fused_windows(kept, bins, records, fv, size, TX)
        for a, b in zip(got, R.raster_fused_windows_plain(kept, bins, records, size, TX)):
            assert torch.equal(a, b)
        if compact is not None:  # the packed route K2's contract describes
            s, e, recs, dropped = R.packed_layout_plain(records, bins, counts, compact)
            assert torch.equal(dropped, overflow)
            for a, b in zip(got, R._fused_plain(s, e, recs, size, TX)):
                assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert R.raster_fused_windows.launches == 3
    assert int(R._windows(counts, 8)[1].min()) > 0  # budget 8 drops chunks


def test_wrappers_reject_bad_arguments(card):
    """K1 and K3 refuse a wrong bins dtype, a wrong record width, face
    vertices that do not match the records and inputs on two devices; K1's
    call without the face vertices (its signature before the cull) raises;
    K6 refuses 32-float records and its old window-form call."""
    kept = torch.ones((1, 8), dtype=torch.int32, device=card)
    bins = torch.full((1, 8, 64), -1, dtype=torch.int32, device=card)
    recs = torch.zeros((1, 40, 32), device=card)
    fv = torch.zeros((1, 40, 3, 3), device=card)
    with pytest.raises(TypeError):
        R.raster_fused_windows(kept, bins.long(), recs, fv, 64, 1)
    with pytest.raises(ValueError):
        R.raster_fused_windows(kept, bins, recs[:, :, :16].contiguous(), fv, 64, 1)
    with pytest.raises(ValueError):
        R.raster_fused_windows(kept.cpu(), bins, recs, fv, 64, 1)
    with pytest.raises(ValueError):
        R.raster_fused_windows(kept, bins, recs, fv[:, :20].contiguous(), 64, 1)
    with pytest.raises(TypeError):
        R.raster_fused_windows(kept, bins, recs, 64, 1)
    with pytest.raises(TypeError):
        R.raster_planes_windows(kept, bins.float(), recs, fv, 64, 1, 3)
    with pytest.raises(ValueError):
        R.raster_planes_windows(kept, bins, recs[:, :, :16].contiguous(), fv, 64, 1, 3)
    with pytest.raises(ValueError):
        R.raster_planes_windows(kept, bins, recs, fv[:, :20].contiguous(), 64, 1, 3)
    # K6 takes 16-float records and the face vertices; its old
    # (starts, ends, recs, image_size, tiles_x) call raises
    crec = torch.zeros((1, 40, 16), device=card)
    with pytest.raises(ValueError):
        R.raster_coverage_windows(kept, bins, recs, fv, 64, 1)
    with pytest.raises(TypeError):
        R.raster_coverage_windows(kept, kept, crec, 64, 1)


@pytest.mark.parametrize("size", [64, 100])
def test_kept_past_the_bins_is_clamped_as_plain(card, size):
    """A kept count past the bins' C/32 chunks (or below 0): K1 and K3 clamp
    it to [0, C/32] on the card as their plain versions do, bitwise."""
    B = 2
    fv, fn = _face_region(card, B, size, 4)
    TX = -(-size // R.TILE_COLS)
    cap = 128
    bins, counts = R.bin_faces_flat(fv, size, cap)
    kept = R._windows(counts, None)[0]
    over = torch.where(kept > 0, kept + 3, -1).to(torch.int32)  # past C/32 = 4, or < 0
    fr, pr = R.fused_records(fv, fn), R.planes_records(fv, fn)
    for a, b in zip(R.raster_fused_windows(over, bins, fr, fv.contiguous(), size, TX),
                    R.raster_fused_windows_plain(over, bins, fr, size, TX)):
        assert torch.equal(a, b)
    for a, b in zip(R.raster_planes_windows(over, bins, pr, fv.contiguous(), size, TX, 3),
                    R.raster_planes_windows_plain(over, bins, pr, size, TX, 3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("full,size,B", [(False, 64, 2), (False, 100, 2), (True, 224, 3)])
def test_training_kernels_match_plain(card, full, size, B):
    """K3 (read through the bins, culled) bitwise equal to its plain version
    and to the packed route on the compact, padded and a truncated layout;
    K4 and K5 within 1e-5 x the sum of the magnitudes of their terms (their
    atomics reorder fp32 sums), each case launching only its kernels: K4's
    store epilogue and K5 on its 9-channel rows (4-byte pieces), K4's fold
    epilogue against the plain composition, and K5 on 36-channel rows
    (float4 pieces, and 4-byte pieces on a view that is not 16-byte
    aligned) with NaN in every row of a slot that holds no face; the raster
    gradient against the CPU path."""
    bundle = procedural_bundle(seed=2, full_size=full)
    rng = np.random.default_rng(1)
    vt = bundle["v_template"]
    verts = torch.from_numpy(
        (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32)).to(card)
    cam = torch.tensor([[7.0, 0.0, 0.0]] * B, device=card)
    r = Renderer(bundle, image_size=size, device=card)
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    cap = r.bin_capacity
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    records = R.planes_records(fv, fn)
    R.reset_launch_counts()
    for compact in (r.raster_compact, 8, None):
        kept, _ = R._windows(counts, compact)
        got = R.raster_planes_windows(kept, bins, records, fv, size, TX, 3)
        for a, b in zip(got, R.raster_planes_windows_plain(kept, bins, records, size, TX, 3)):
            assert torch.equal(a, b)
        if compact is not None:
            s, e, recs, _ = R.packed_layout_plain(records, bins, counts, compact)
            for a, b in zip(got, R._planes_plain(s, e, recs, size, TX, 3)):
                assert torch.equal(a, b)
    slots = R.raster_planes_windows(R._windows(counts, r.raster_compact)[0], bins, records,
                                    fv, size, TX, 3)[2]
    torch.cuda.synchronize()
    assert R.raster_planes_windows.launches == 4
    g = torch.randn((B, size, size, 3), device=card,
                    generator=torch.Generator(device=card).manual_seed(0))
    g_t = R.image_to_tiles(g, size).contiguous()
    scale = R.segment_sum(slots, R.moment_rows(g_t, size).abs(), cap)
    F = fv.shape[1]

    def store():
        k4 = R.segment_moments(slots, g_t, cap, size)
        assert ((k4 - R.segment_moments_plain(slots, g_t, cap, size)).abs()
                <= 1e-5 * scale + 1e-30).all()
        k5 = R.fold_slots_to_faces(k4, bins, F)
        assert ((k5 - R.fold_slots_to_faces_plain(k4, bins, F)).abs()
                <= 1e-5 * R.fold_slots_to_faces_plain(k4.abs(), bins, F) + 1e-30).all()
        assert float(k5.abs().sum()) > 0

    def fold():
        k4 = R.segment_moments_to_faces(slots, g_t, bins, cap, size, F)
        want = R.segment_moments_to_faces_plain(slots, g_t, bins, cap, size, F)
        assert ((k4 - want).abs()
                <= 1e-5 * R.fold_slots_to_faces_plain(scale, bins, F) + 1e-30).all()
        assert float(k4.abs().sum()) > 0

    def k5_36():
        gen = torch.Generator(device=card).manual_seed(5)
        rows = torch.randn(tuple(bins.shape) + (36,), device=card, generator=gen)
        rows = torch.where((bins < 0)[..., None], float("nan"), rows)
        unaligned = torch.empty(rows.numel() + 1, device=card)[1:].view(rows.shape)
        unaligned.copy_(rows)
        assert unaligned.data_ptr() % 16 and rows.data_ptr() % 16 == 0
        want = R.fold_slots_to_faces_plain(rows, bins, F)
        for per_slot in (rows, unaligned):
            k5 = R.fold_slots_to_faces(per_slot, bins, F)
            assert bool(torch.isfinite(k5).all())
            assert ((k5 - want).abs() <= 1e-5 * R.fold_slots_to_faces_plain(
                rows.abs(), bins, F) + 1e-30).all()

    # (K4 store, K4 fold, K5) launches of each case
    for case, launched in ((store, (1, 0, 1)), (fold, (0, 1, 0)), (k5_36, (0, 0, 2))):
        R.reset_launch_counts()
        case()
        torch.cuda.synchronize()
        assert (R.raster_planes_windows.launches, R.segment_moments.launches,
                R.segment_moments_to_faces.launches, R.fold_slots_to_faces.launches) == \
            (0, *launched), case.__name__

    fvg, fng = fv.clone().requires_grad_(True), fn.clone().requires_grad_(True)
    vals, _, p2f, _ = R.rasterize(fvg, fng, size, cap, compact=r.raster_compact)
    w = torch.randn(vals.shape, device=card, generator=torch.Generator(device=card).manual_seed(1))
    d_fv, d_fn = torch.autograd.grad((vals * w).sum(), (fvg, fng))
    fvc, fnc = fv.cpu().requires_grad_(True), fn.cpu().requires_grad_(True)
    vc, _, pc, _ = R.rasterize(fvc, fnc, size, cap, compact=r.raster_compact)
    dc_fv, dc_fn = torch.autograd.grad((vc * w.cpu()).sum(), (fvc, fnc))
    assert torch.equal(pc, p2f.cpu()) and torch.equal(vc, vals.detach().cpu())
    # 1e-4 x the kappa^2-weighted term magnitudes: the atomics sum the
    # pixel terms in another order than the CPU (see the scale's docstring)
    _, sc_fv, _, sc_fn = R.dense_gradient_and_scale(pc, fv.cpu(), fn.cpu(), w.cpu())
    for a, b, sc in ((d_fv, dc_fv, sc_fv), (d_fn, dc_fn, sc_fn)):
        assert ((a.cpu().double() - b.double()).abs() <= 1e-4 * sc + 1e-30).all()


def _sliver_faces(card, B=2, S=224, F=3000):
    """(B,F,3,3) faces on S px images: random faces of 0.3 to 16 px, a third
    of them replaced by slivers and near-degenerate faces along pixel rows
    (the faces the cull boxes leave unbounded), and (B,F,3,3) attributes."""
    rng = np.random.default_rng(7)
    p0 = rng.uniform(-10, S + 10, (B, F, 1, 2))
    pts = p0 + rng.normal(size=(B, F, 3, 2)) * 10 ** rng.uniform(-0.5, 1.2, (B, F, 1, 1))
    sl = rng.random((B, F)) < 1 / 3
    base = np.concatenate([p0[..., 0], np.round(p0[..., 1])], -1)  # (B,F,2), on a row
    length = rng.uniform(0.2, 30.0, (B, F, 1))
    off = 10 ** rng.uniform(-9, -1, (B, F, 1))
    t = rng.uniform(-0.5, 1.5, (B, F, 1))
    sliver = np.stack([base, base + np.concatenate([length, 0 * length], -1),
                       base + np.concatenate([t * length, off], -1)], 2)
    pts = np.where(sl[..., None, None], sliver, pts)
    xy = (2.0 * pts - S + 1.0) / S
    fv = torch.tensor(np.concatenate([xy, rng.uniform(9, 11, (B, F, 3, 1))], -1),
                      dtype=torch.float32, device=card)
    attrs = torch.tensor(rng.normal(size=(B, F, 3, 3)), dtype=torch.float32, device=card)
    return fv, attrs


def test_culled_planes_kernel_matches_plain_on_slivers(card):
    """Culled K3 bitwise equal to its plain version, which tests every face,
    on the sliver batch (`_sliver_faces`), on the padded layout and at a
    budget that drops chunks."""
    S, cap = 224, 512
    fv, attrs = _sliver_faces(card, S=S)
    TX = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, cap)
    records = R.planes_records(fv, attrs)
    assert bool(torch.isinf(R.cull_boxes(fv, S)[..., 0]).any())
    for compact in (None, 64):
        kept, _ = R._windows(counts, compact)
        got = R.raster_planes_windows(kept, bins, records, fv, S, TX, 3)
        for a, b in zip(got, R.raster_planes_windows_plain(kept, bins, records, S, TX, 3)):
            assert torch.equal(a, b)
        assert float((got[0] >= 0).float().mean()) > 0.05


def test_culled_coverage_kernel_matches_plain_on_slivers(card):
    """Culled K6 (16-float records read through the bins, two staging
    halves) bitwise equal to its plain version, which tests every face, and
    to K3's coverage outputs, on the sliver batch at capacity 512 and at
    kept counts truncated to 2 chunks."""
    S, cap = 224, 512
    fv, attrs = _sliver_faces(card, S=S)
    TX = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, cap)
    crec = R.coverage_records(fv)
    assert bool(torch.isinf(R.cull_boxes(fv, S)[..., 0]).any())
    R.reset_launch_counts()
    full = R._windows(counts, None)[0]
    for kept in (full, full.clamp(max=2)):
        got = R.raster_coverage_windows(kept, bins, crec, fv, S, TX)
        for a, b in zip(got, R.raster_coverage_windows_plain(kept, bins, crec, S, TX)):
            assert torch.equal(a, b)
        k3 = R.raster_planes_windows(kept, bins, R.planes_records(fv, attrs), fv, S, TX, 3)
        for a, b in zip(got, k3[:3]):
            assert torch.equal(a, b)
        assert float((got[0] >= 0).float().mean()) > 0.05
    torch.cuda.synchronize()
    assert R.raster_coverage_windows.launches == 2
    assert int(full.max()) > 2


def test_culled_fused_and_bins_kernels_match_plain_on_slivers(card):
    """Culled K1 (compact at 216 chunks, padded, and a budget of 64 that
    drops chunks) and culled K8 bitwise equal to their plain versions,
    which test every face, on the sliver batch; both cull-box functions
    leave some of its faces unbounded."""
    S, cap = 224, 512
    fv, normals = _sliver_faces(card, S=S)
    B, F = fv.shape[:2]
    TX = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, cap)
    records = R.fused_records(fv, normals)
    assert bool(torch.isinf(R.cull_boxes(fv, S)[..., 0]).any())
    assert bool(torch.isinf(R.cull_boxes_bins(fv, S)[..., 0]).any())
    R.reset_launch_counts()
    for compact in (216, None, 64):
        kept, _ = R._windows(counts, compact)
        got = R.raster_fused_windows(kept, bins, records, fv, S, TX)
        for a, b in zip(got, R.raster_fused_windows_plain(kept, bins, records, S, TX)):
            assert torch.equal(a, b)
        assert float((got[0] >= 0).float().mean()) > 0.05
    fv9 = fv.reshape(B, F, 9).contiguous()
    k8 = R.raster_bins_coverage(counts, bins, fv9, S)
    for a, b in zip(k8, R.raster_bins_coverage_plain(counts, bins, fv9, S)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert (R.raster_fused_windows.launches, R.raster_bins_coverage.launches) == (3, 1)
    assert int(R._windows(counts, 64)[1].min()) > 0


def test_bins_kernel_keeps_negative_zero_barycentrics(card):
    """K8 rejects a pixel before dividing only where a barycentric is surely
    negative: at the centre row of a 65 px image the face (0, 1),
    (1, 2^-149), (-1, 0) covers pixels through w_0 = -0 in its plain
    version, and the kernel equals it bitwise."""
    S = 65
    fv = torch.tensor([[[[0.0, 1.0, 10.0], [1.0, 2.0 ** -149, 10.0], [-1.0, 0.0, 10.0]]]],
                      device=card)
    bins, counts = R.bin_faces_flat(fv, S, 32)
    fv9 = fv.reshape(1, 1, 9).contiguous()
    got = R.raster_bins_coverage(counts, bins, fv9, S)
    want = R.raster_bins_coverage_plain(counts, bins, fv9, S)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((want[0][0, S // 2, :S] == 0).sum()) >= 3


@pytest.mark.parametrize("epilogue", ["store", "fold"])
def test_training_wrappers_reject_bad_arguments(card, epilogue):
    """K4 (either epilogue) refuses int slots of another dtype, slots that
    disagree with g and, folding, a bins of another dtype, shape or
    device; K5 refuses a bins that disagrees with its rows; K3 refuses a
    D its records cannot hold."""
    slots = torch.zeros((1, 8, 1024), dtype=torch.int32, device=card)
    g = torch.zeros((1, 8, 1024, 3), device=card)
    bins32 = torch.full((1, 8, 32), -1, dtype=torch.int32, device=card)
    if epilogue == "store":
        def k4(sl, gg):
            return R.segment_moments(sl, gg, 32, 64)
    else:
        def k4(sl, gg, bb=bins32):
            return R.segment_moments_to_faces(sl, gg, bb, 32, 64, 10)
        for bad in (bins32.long(), bins32[:, :4], bins32[..., :16], bins32.cpu()):
            with pytest.raises((TypeError, ValueError)):
                k4(slots, g, bad)
        assert k4(slots, g).shape == (1, 10, 9)
    with pytest.raises(TypeError):
        k4(slots.float(), g)
    with pytest.raises(ValueError):
        k4(slots[:, :4], g)  # slots and g disagree
    with pytest.raises(ValueError):
        R.fold_slots_to_faces(g[..., :32, :].contiguous(), slots[..., :16], 10)
    kept = torch.zeros((1, 8), dtype=torch.int32, device=card)
    bins = torch.full((1, 8, 32), -1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        R.raster_planes_windows(kept, bins, torch.zeros((1, 32, 32), device=card),
                                torch.zeros((1, 32, 3, 3), device=card), 64, 1, 7)


def _face_region(card, B, size, seed):
    bundle = procedural_bundle(seed=2, full_size=True)
    rng = np.random.default_rng(seed)
    vt = bundle["v_template"]
    verts = torch.from_numpy(
        (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32)).to(card)
    cam = torch.tensor([[7.0, 0.0, 0.0]] * B, device=card)
    r = Renderer(bundle, image_size=size, device=card)
    return r._face_geometry(verts, r.project(verts, cam))


@pytest.mark.parametrize("size,B,cap", [(64, 2, 96), (224, 3, 384), (224, 2, 512)])
def test_coverage_kernels_match_plain(card, size, B, cap):
    """K6 (records read through the padded bins, the warp cull) bitwise
    equal to its plain version and to K3's coverage outputs on the same
    (kept, bins, face_verts); K8 bitwise equal to its plain version."""
    fv, fn = _face_region(card, B, size, 3)
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    kept = R._windows(counts, None)[0]
    crec = R.coverage_records(fv)
    R.reset_launch_counts()
    k6 = R.raster_coverage_windows(kept, bins, crec, fv, size, TX)
    for a, b in zip(k6, R.raster_coverage_windows_plain(kept, bins, crec, size, TX)):
        assert torch.equal(a, b)
    k3 = R.raster_planes_windows(kept, bins, R.planes_records(fv, fn), fv, size, TX, 3)
    for a, b in zip(k6, k3[:3]):
        assert torch.equal(a, b)
    fv9 = fv.reshape(B, -1, 9).contiguous()
    k8 = R.raster_bins_coverage(counts, bins, fv9, size)
    for a, b in zip(k8, R.raster_bins_coverage_plain(counts, bins, fv9, size)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert (R.raster_coverage_windows.launches, R.raster_bins_coverage.launches) == (1, 1)
    assert float((k6[0] >= 0).float().mean()) > 0.02  # the uncentred head at 64 px covers ~4 %


@pytest.mark.parametrize("B,cap,chn", [(2, 512, 36), (1, 1024, 72), (2, 96, 7)])
def test_segment_reduce_matches_plain(card, B, cap, chn):
    """K7 within 1e-5 x the sum of the magnitudes of its terms: 3 runs of
    176 slots at C=512, CHN=36, 10 of 104 at C=1024, CHN=72 (295 KB in all,
    past the opt-in limit), one block of 7 channels in 4-byte pieces at
    C=96. Every row whose slot is -1 or >= C holds NaN, which the contract
    drops (and K7 never reads): the output stays finite."""
    gen = torch.Generator(device=card).manual_seed(cap)
    slots = torch.randint(-1, cap + cap // 8, (B, 56, 1024), device=card, generator=gen,
                          dtype=torch.int32)
    payload = torch.randn((B, 56, 1024, chn), device=card, generator=gen)
    payload[payload.abs() < 0.1] = 0.0
    dropped = (slots < 0) | (slots >= cap)
    assert bool((slots >= cap).any()) and bool((slots < 0).any())
    zeroed = torch.where(dropped[..., None], 0.0, payload)
    payload = torch.where(dropped[..., None], float("nan"), payload)
    R.reset_launch_counts()
    got = R.segment_reduce_tiles(slots, payload, cap)
    want = R.segment_sum(slots, payload, cap)
    scale = R.segment_sum(slots, payload.abs(), cap)
    torch.cuda.synchronize()
    assert R.segment_reduce_tiles.launches == 1
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    assert ((got - want).abs() <= 1e-5 * scale + 1e-30).all()
    # the plain version's own atomics reorder its sums on the card too
    assert ((want - R.segment_sum(slots, zeroed, cap)).abs() <= 1e-5 * scale + 1e-30).all()
    assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("epilogue", ["store", "fold"])
def test_segment_moments_past_48kb_matches_plain(card, epilogue):
    """K4 at D = 6, capacity 768 (55 KB of accumulators) and capacity 4096
    (295 KB: the channels split), and at D = 5, capacity 4096 (the walk's
    second pass over g takes 2 channels) within 1e-5 x the sum of
    magnitudes: the store epilogue against its plain version, the fold
    epilogue (random face ids in [-1, 3408) a slot) against the plain
    composition."""
    gen = torch.Generator(device=card).manual_seed(0)
    F = 3408
    for cap, D in ((768, 6), (4096, 6), (4096, 5)):
        slots = torch.randint(-1, cap, (2, 56, 1024), device=card, generator=gen,
                              dtype=torch.int32)
        g = torch.randn((2, 56, 1024, D), device=card, generator=gen)
        scale = R.segment_sum(slots, R.moment_rows(g, 224).abs(), cap)
        if epilogue == "store":
            got = R.segment_moments(slots, g, cap, 224)
            want = R.segment_moments_plain(slots, g, cap, 224)
        else:
            bins = torch.randint(-1, F, (2, 56, cap), device=card, generator=gen,
                                 dtype=torch.int32)
            got = R.segment_moments_to_faces(slots, g, bins, cap, 224, F)
            want = R.segment_moments_to_faces_plain(slots, g, bins, cap, 224, F)
            scale = R.fold_slots_to_faces_plain(scale, bins, F)
        torch.cuda.synchronize()
        assert ((got - want).abs() <= 1e-5 * scale + 1e-30).all(), (cap, D)


def test_rasterize_wide_attributes_on_the_card(card):
    """rasterize with D = 9 on the card: K6 forward, K7 + K5 backward, the
    values equal to the gather-based interpolation; the gradient within
    1e-5 x the per-pixel terms' magnitudes of the dense reference on the
    card (the same terms, summed in another order), and within 1e-4 x the
    kappa^2-weighted scale of the CPU path's (the per-pixel terms round
    differently on the two devices, amplified by the edge condition)."""
    fv, fn = _face_region(card, 2, 224, 4)
    attrs = torch.cat([fn, fv, fn * 0.5], -1)
    fvg, atg = fv.clone().requires_grad_(True), attrs.clone().requires_grad_(True)
    R.reset_launch_counts()
    vals, mask, p2f, ovf = R.rasterize(fvg, atg, 224, 512)
    w = torch.randn(vals.shape, device=card, generator=torch.Generator(device=card).manual_seed(1))
    d_fv, d_at = torch.autograd.grad((vals * w).sum(), (fvg, atg))
    torch.cuda.synchronize()
    assert (R.raster_coverage_windows.launches, R.segment_reduce_tiles.launches,
            R.fold_slots_to_faces.launches, R.raster_planes_windows.launches) == (1, 1, 1, 0)
    assert torch.equal(vals.detach(), R.interpolate_attributes(p2f, fv, attrs)[0])
    assert int(ovf.abs().max()) == 0
    fvc, atc = fv.cpu().requires_grad_(True), attrs.cpu().requires_grad_(True)
    vc, _, pc, _ = R.rasterize(fvc, atc, 224, 512)
    dc_fv, dc_at = torch.autograd.grad((vc * w.cpu()).sum(), (fvc, atc))
    assert torch.equal(pc, p2f.cpu())
    ref_fv, sc_fv, ref_at, sc_at = R.dense_gradient_and_scale(p2f, fv, attrs, w,
                                                              weighted=False)
    for a, b, sc in ((d_fv, ref_fv, sc_fv), (d_at, ref_at, sc_at)):
        assert ((a.double() - b.double()).abs() <= 1e-5 * sc + 1e-30).all()
    _, kc_fv, _, kc_at = R.dense_gradient_and_scale(pc, fv.cpu(), attrs.cpu(), w.cpu())
    for a, b, sc in ((d_fv, dc_fv, kc_fv), (d_at, dc_at, kc_at)):
        assert ((a.cpu().double() - b.double()).abs() <= 1e-4 * sc + 1e-30).all()


@pytest.mark.parametrize("size,B,cap,tps", [(64, 2, 96, 8), (224, 3, 384, 8),
                                            (224, 2, 384, 16), (224, 1, 384, 24)])
def test_group_kernels_match_plain(card, size, B, cap, tps):
    """K9 bitwise equal to its plain version, the merged schedule (every
    tile of a group walked to the group's largest count), and to K1 on the
    padded windows; K10 bitwise equal to its plain version on count-sorted
    tiles, whose records it rebases to tile-local coordinates as it stages
    them, and to the packed route (`sorted_tiles`)."""
    fv, fn = _face_region(card, B, size, 5)
    fv = fv.contiguous()
    TX = -(-size // R.TILE_COLS)
    bins, counts = R._pad_tiles_to(*R.bin_faces_flat(fv, size, cap), tps)
    records = R.fused_records(fv, fn)
    kw = dict(image_size=size, tiles_x=TX, tps=tps)
    R.reset_launch_counts()
    k9 = R.raster_fused_groups(counts, bins, records, fv, **kw)
    k1b = R.raster_fused_windows(R._windows(counts, None)[0], bins, records, fv, size, TX)
    for a, b, c in zip(k9, R.raster_fused_groups_plain(counts, bins, records, **kw), k1b):
        assert torch.equal(a, b) and torch.equal(a, c)
    sc, sb, order, _ = R.sort_tiles_order(bins, counts)
    k10 = R.raster_fused_groups_local(sc, sb, order, records, fv, **kw)
    pc, precs, _ = R.sorted_tiles(records, bins, counts, size)
    packed = R._fused_plain(*R.group_windows(pc, bins.shape[2] // 32, tps), precs, size, TX,
                            local=True)
    for a, b, c in zip(k10, R.raster_fused_groups_local_plain(sc, sb, order, records, **kw),
                       packed):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.cuda.synchronize()
    assert (R.raster_fused_groups.launches, R.raster_fused_groups_local.launches) == (1, 1)
    assert float((k9[0] >= 0).float().mean()) > 0.02


@pytest.mark.parametrize("size,B,chunk,cap", [(64, 2, 4, 64), (224, 3, 8, 128),
                                              (224, 2, 16, 96), (224, 2, 32, 64),
                                              (224, 1, 8, 4)])
def test_chunkskip_kernel_matches_plain(card, size, B, chunk, cap):
    """K11 bitwise equal to its plain version on a Morton-permuted face
    list with the original ids, at each chunk size and a truncated cap."""
    fv, fn = _face_region(card, B, size, 6)
    bundle = procedural_bundle(seed=2, full_size=True)
    r = Renderer(bundle, image_size=size, device="cpu")
    perm = R.spatial_face_order(np.asarray(bundle["v_template"])[r.kept_vertices],
                                r.faces.numpy())
    counts, clist, recs, fvp, dropped = R.chunkskip_inputs(fv[:, perm], fn[:, perm], size,
                                                           chunk, cap, perm)
    kw = dict(image_size=size, tiles_x=-(-size // R.TILE_COLS), chunk=chunk)
    R.reset_launch_counts()
    got = R.raster_chunkskip(counts, clist, recs, fvp, **kw)
    for a, b in zip(got, R.raster_chunkskip_plain(counts, clist, recs, **kw)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert R.raster_chunkskip.launches == 1
    assert int(got[0].max()) < fv.shape[1]
    if cap == 4:
        assert int(dropped.min()) > 0


def test_culled_schedule_kernels_match_plain_on_slivers(card):
    """K9 (tps 8), K10 and K11 at each chunk size (4, 8, 16, 32; the faces
    padded to a multiple of it, lists ending in a partial step) bitwise
    equal to their plain versions, which test every face, on the sliver
    batch, whose thinnest faces the cull boxes leave unbounded."""
    S, cap = 224, 512
    fv, normals = _sliver_faces(card, S=S, F=2997)
    TX = -(-S // R.TILE_COLS)
    assert bool(torch.isinf(R.cull_boxes_local(fv, S)[..., 0]).any())
    bins, counts = R._pad_tiles_to(*R.bin_faces_flat(fv, S, cap), 8)
    records = R.fused_records(fv, normals)
    kw = dict(image_size=S, tiles_x=TX, tps=8)
    R.reset_launch_counts()
    for a, b in zip(R.raster_fused_groups(counts, bins, records, fv, **kw),
                    R.raster_fused_groups_plain(counts, bins, records, **kw)):
        assert torch.equal(a, b)
    sc, sb, order, _ = R.sort_tiles_order(bins, counts)
    for a, b in zip(R.raster_fused_groups_local(sc, sb, order, records, fv, **kw),
                    R.raster_fused_groups_local_plain(sc, sb, order, records, **kw)):
        assert torch.equal(a, b)
    for chunk in R.CHUNKSKIP_CHUNKS:
        cap11 = -(-fv.shape[1] // chunk)  # every chunk: nothing dropped
        counts11, clist, recs, fvp, dropped = R.chunkskip_inputs(fv, normals, S, chunk, cap11)
        assert int(dropped.max()) == 0 and fvp.shape[1] > fv.shape[1]
        if chunk < 32:
            assert bool(((counts11 * chunk) % 32 != 0).any())  # a partial last step
        kw11 = dict(image_size=S, tiles_x=TX, chunk=chunk)
        got = R.raster_chunkskip(counts11, clist, recs, fvp, **kw11)
        for a, b in zip(got, R.raster_chunkskip_plain(counts11, clist, recs, **kw11)):
            assert torch.equal(a, b)
        assert float((got[0] >= 0).float().mean()) > 0.05
    torch.cuda.synchronize()
    assert (R.raster_fused_groups.launches, R.raster_fused_groups_local.launches,
            R.raster_chunkskip.launches) == (1, 1, 4)


def test_schedule_wrappers_reject_bad_arguments(card):
    """K9 and K10 refuse a tile count that is no multiple of tps, a wrong
    dtype and a wrong order; K11 a chunk size it does not take, records
    that are no multiple of it and face vertices that do not match the
    records; the old positional forms of all three raise."""
    counts = torch.zeros((1, 8), dtype=torch.int32, device=card)
    bins = torch.full((1, 8, 32), -1, dtype=torch.int32, device=card)
    order = torch.arange(8, dtype=torch.int32, device=card)[None]
    recs = torch.zeros((1, 8 * 32, 32), device=card)
    fv = torch.zeros((1, 8 * 32, 3, 3), device=card)
    kw = dict(image_size=64, tiles_x=1, tps=8)
    with pytest.raises(ValueError):
        R.raster_fused_groups(counts, bins, recs, fv, image_size=64, tiles_x=1, tps=3)
    with pytest.raises(TypeError):
        R.raster_fused_groups_local(counts.float(), bins, order, recs, fv, **kw)
    with pytest.raises(TypeError):
        R.raster_fused_groups_local(counts, bins, order.long(), recs, fv, **kw)
    with pytest.raises(ValueError):
        R.raster_fused_groups_local(counts, bins, order[:, :4].contiguous(), recs, fv, **kw)
    with pytest.raises(TypeError):
        R.raster_fused_groups(counts, recs, 64, 1, 8)
    with pytest.raises(TypeError):
        R.raster_fused_groups_local(counts, recs, 64, 8)
    clist = torch.zeros((1, 8, 4), dtype=torch.int32, device=card)
    kw11 = dict(image_size=64, tiles_x=1)
    with pytest.raises(ValueError):
        R.raster_chunkskip(counts, clist, recs, fv, chunk=6, **kw11)  # not 4, 8, 16, 32
    with pytest.raises(ValueError):
        R.raster_chunkskip(counts, clist, recs[:, :250].contiguous(), fv, chunk=8, **kw11)
    with pytest.raises(ValueError):
        R.raster_chunkskip(counts, clist, recs, fv[:, :128].contiguous(), chunk=8, **kw11)
    with pytest.raises(TypeError):
        R.raster_chunkskip(counts, clist, recs, 64, 1, 8)
    out = R.raster_chunkskip(counts, clist, recs, fv, chunk=8, **kw11)
    torch.cuda.synchronize()
    assert int(out[0].max()) == -1


def test_k1_op_and_served_artifact(card, tmp_path):
    """K1's custom op passes torch.library.opcheck on CUDA tensors (its
    CUDA implementation: the launch); an inference artifact exported on the
    card at b8 (tiny backbones, 224 px) calls the op once, launches K1 once
    a call and equals SmirkSystem.infer bitwise, also with the global TF32
    flags True (the call's fp32 pin)."""
    from smirk_tpu_torch import serving
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.train import SmirkSystem

    fv, fn = _face_region(card, 2, 224, 0)
    TX = 2
    bins, counts = R.bin_faces_flat(fv, 224, 384)
    records = R.fused_records(fv, fn)
    kept, _ = R._windows(counts, 216)
    checks = torch.library.opcheck(R._k1_op, (kept, bins, records, fv.contiguous(), 224, TX))
    assert set(checks.values()) == {"SUCCESS"}, checks

    tiny = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
    stages = {"tf_mobilenetv3_small_minimal_100": tiny,
              "tf_mobilenetv3_large_minimal_100": tiny}
    bundle = procedural_bundle(seed=2, full_size=True)
    system = SmirkSystem(Config(), bundle, device=card, backbone_stages=stages,
                         training=False)
    call = serving.load_inference(
        serving.export_inference(system, str(tmp_path / "art"), batch_size=8))
    assert sum(R.K1_OP.replace("::", ".") in str(n.target)
               for n in call.modules[0].graph.nodes) == 1
    img = np.random.default_rng(0).random((8, 224, 224, 3), np.float32)
    want = system.infer(torch.from_numpy(img))
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            R.reset_launch_counts()
            got = call(img)
            torch.cuda.synchronize()
            assert R.raster_fused_windows.launches == 1
            for k in serving.OUTPUT_KEYS:
                assert torch.equal(got[k], want[k]), k
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
