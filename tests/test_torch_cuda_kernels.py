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
    CPT = cap // R.V3_CHUNK
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    Tp = bins.shape[1]
    bins3 = bins.reshape(B, Tp * CPT, R.V3_CHUNK)
    records = R.fused_records(fv, fn)
    R.reset_launch_counts()
    for budget in (r.raster_compact, 8):
        s, e, tof, total, _ = R._compact_plan(counts, budget)
        faces = R.compact_faces(tof, s, total, bins3, CPT)
        assert torch.equal(faces, R.compact_faces_plain(tof, s, total, bins3, CPT))
        recs = R._gather_recs(records, faces.reshape(B, -1)).contiguous()
        got = R.raster_fused_windows(s, e, recs, size, TX)
        want = R.raster_fused_windows_plain(s, e, recs, size, TX)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    ps, pe = R.padded_windows(counts, CPT)
    recs = R._gather_recs(records, bins.reshape(B, -1)).contiguous()
    for a, b in zip(R.raster_fused_windows(ps, pe, recs, size, TX),
                    R.raster_fused_windows_plain(ps, pe, recs, size, TX)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert R.compact_faces.launches == 2 and R.raster_fused_windows.launches == 3


def test_wrappers_reject_bad_arguments(card):
    starts = torch.zeros((1, 8), dtype=torch.int32, device=card)
    recs = torch.zeros((1, 32, 32), device=card)
    with pytest.raises(TypeError):
        R.raster_fused_windows(starts.float(), starts, recs, 64, 1)
    with pytest.raises(ValueError):
        R.raster_fused_windows(starts, starts, recs[:, :, :16].contiguous(), 64, 1)
    with pytest.raises(ValueError):
        R.raster_fused_windows(starts, starts.cpu(), recs, 64, 1)


@pytest.mark.parametrize("full,size,B", [(False, 64, 2), (False, 100, 2), (True, 224, 3)])
def test_training_kernels_match_plain(card, full, size, B):
    """K3 bitwise on the compact, padded and a truncated layout; K4 and K5
    within 1e-5 x the sum of the magnitudes of their terms (their atomics
    reorder fp32 sums); the raster gradient against the CPU path."""
    bundle = procedural_bundle(seed=2, full_size=full)
    rng = np.random.default_rng(1)
    vt = bundle["v_template"]
    verts = torch.from_numpy(
        (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32)).to(card)
    cam = torch.tensor([[7.0, 0.0, 0.0]] * B, device=card)
    r = Renderer(bundle, image_size=size, device=card)
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    cap = r.bin_capacity
    CPT = cap // R.V3_CHUNK
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    Tp = bins.shape[1]
    records = R.planes_records(fv, fn)
    R.reset_launch_counts()
    layouts = []
    for budget in (r.raster_compact, 8):
        s, e, tof, total, _ = R._compact_plan(counts, budget)
        faces = R.compact_faces(tof, s, total, bins.reshape(B, Tp * CPT, R.V3_CHUNK), CPT)
        layouts.append((s, e, R._gather_recs(records, faces.reshape(B, -1)).contiguous()))
    ps, pe = R.padded_windows(counts, CPT)
    layouts.append((ps, pe, R._gather_recs(records, bins.reshape(B, -1)).contiguous()))
    for s, e, recs in layouts:
        got = R.raster_planes_windows(s, e, recs, size, TX, 3)
        want = R.raster_planes_windows_plain(s, e, recs, size, TX, 3)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    slots = R.raster_planes_windows(*layouts[0], size, TX, 3)[2]
    g = torch.randn((B, size, size, 3), device=card,
                    generator=torch.Generator(device=card).manual_seed(0))
    g_t = R.image_to_tiles(g, size).contiguous()
    k4 = R.segment_moments(slots, g_t, cap, size)
    scale = R.segment_sum(slots, R.moment_rows(g_t, size).abs(), cap)
    assert ((k4 - R.segment_moments_plain(slots, g_t, cap, size)).abs()
            <= 1e-5 * scale + 1e-30).all()
    F = fv.shape[1]
    k5 = R.fold_slots_to_faces(k4, bins, F)
    assert ((k5 - R.fold_slots_to_faces_plain(k4, bins, F)).abs()
            <= 1e-5 * R.fold_slots_to_faces_plain(k4.abs(), bins, F) + 1e-30).all()
    assert float(k5.abs().sum()) > 0
    torch.cuda.synchronize()
    assert (R.raster_planes_windows.launches, R.segment_moments.launches,
            R.fold_slots_to_faces.launches) == (4, 1, 1)

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


def test_training_wrappers_reject_bad_arguments(card):
    slots = torch.zeros((1, 8, 1024), dtype=torch.int32, device=card)
    g = torch.zeros((1, 8, 1024, 3), device=card)
    with pytest.raises(TypeError):
        R.segment_moments(slots.float(), g, 32, 64)
    with pytest.raises(ValueError):
        R.segment_moments(slots[:, :4], g, 32, 64)  # slots and g disagree
    with pytest.raises(ValueError):
        R.fold_slots_to_faces(g[..., :32, :].contiguous(), slots[..., :16], 10)
    starts = torch.zeros((1, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        R.raster_planes_windows(starts, starts, torch.zeros((1, 32, 32), device=card), 64, 1, 7)


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
    """K6 bitwise equal to its plain version and to K3's coverage outputs on
    the same padded bins; K8 bitwise equal to its plain version."""
    fv, fn = _face_region(card, B, size, 3)
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces(fv, size, cap)
    s, e, recs, _ = R._layout(R.coverage_records(fv), bins, counts, cap, None)
    R.reset_launch_counts()
    k6 = R.raster_coverage_windows(s, e, recs, size, TX)
    for a, b in zip(k6, R.raster_coverage_windows_plain(s, e, recs, size, TX)):
        assert torch.equal(a, b)
    _, _, recs3, _ = R._layout(R.planes_records(fv, fn), bins, counts, cap, None)
    k3 = R.raster_planes_windows(s, e, recs3, size, TX, 3)
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
    """K7 within 1e-5 x the sum of the magnitudes of its terms: 74 KB of
    accumulators per block at C=512, CHN=36, and a channel split at
    C=1024, CHN=72 (295 KB, past the opt-in limit)."""
    gen = torch.Generator(device=card).manual_seed(cap)
    slots = torch.randint(-1, cap, (B, 56, 1024), device=card, generator=gen,
                          dtype=torch.int32)
    payload = torch.randn((B, 56, 1024, chn), device=card, generator=gen)
    payload[payload.abs() < 0.1] = 0.0
    R.reset_launch_counts()
    got = R.segment_reduce_tiles(slots, payload, cap)
    want = R.segment_sum(slots, payload, cap)
    scale = R.segment_sum(slots, payload.abs(), cap)
    torch.cuda.synchronize()
    assert R.segment_reduce_tiles.launches == 1
    assert ((got - want).abs() <= 1e-5 * scale + 1e-30).all()
    assert float(got.abs().sum()) > 0


def test_segment_moments_past_48kb_matches_plain(card):
    """K4 at D = 6, capacity 768 (55 KB of accumulators) and capacity 4096
    (295 KB: the channels split) within 1e-5 x the sum of magnitudes."""
    gen = torch.Generator(device=card).manual_seed(0)
    for cap in (768, 4096):
        slots = torch.randint(-1, cap, (2, 56, 1024), device=card, generator=gen,
                              dtype=torch.int32)
        g = torch.randn((2, 56, 1024, 6), device=card, generator=gen)
        got = R.segment_moments(slots, g, cap, 224)
        want = R.segment_moments_plain(slots, g, cap, 224)
        scale = R.segment_sum(slots, R.moment_rows(g, 224).abs(), cap)
        torch.cuda.synchronize()
        assert ((got - want).abs() <= 1e-5 * scale + 1e-30).all(), cap


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
    """K9 bitwise equal to its plain version and to K1 on the padded
    windows (tps 16 takes 192 KB of shared memory by opt-in, tps 24 runs
    in passes); K10 bitwise equal to its plain version on count-sorted
    tile-local records."""
    fv, fn = _face_region(card, B, size, 5)
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, cap)
    bins, counts = R._pad_tiles_to(bins, counts, tps)
    recs = R._gather_recs(R.fused_records(fv, fn), bins.reshape(B, -1)).contiguous()
    R.reset_launch_counts()
    k9 = R.raster_fused_groups(counts, recs, size, TX, tps)
    ps, pe = R.padded_windows(counts, cap // R.V3_CHUNK)
    k1b = R.raster_fused_windows(ps, pe, recs, size, TX)
    for a, b, c in zip(k9, R.raster_fused_groups_plain(counts, recs, size, TX, tps), k1b):
        assert torch.equal(a, b) and torch.equal(a, c)
    sc, srecs, _ = R.sorted_tiles(R.fused_records(fv, fn), bins, counts, size)
    k10 = R.raster_fused_groups_local(sc, srecs, size, tps)
    for a, b in zip(k10, R.raster_fused_groups_plain(sc, srecs, size, TX, tps, local=True)):
        assert torch.equal(a, b)
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
    counts, clist, recs, dropped = R.chunkskip_inputs(fv[:, perm], fn[:, perm], size,
                                                      chunk, cap, perm)
    TX = -(-size // R.TILE_COLS)
    R.reset_launch_counts()
    got = R.raster_chunkskip(counts, clist, recs, size, TX, chunk)
    for a, b in zip(got, R.raster_chunkskip_plain(counts, clist, recs, size, TX, chunk)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert R.raster_chunkskip.launches == 1
    assert int(got[0].max()) < fv.shape[1]
    if cap == 4:
        assert int(dropped.min()) > 0


def test_schedule_wrappers_reject_bad_arguments(card):
    counts = torch.zeros((1, 8), dtype=torch.int32, device=card)
    recs = torch.zeros((1, 8 * 32, 32), device=card)
    with pytest.raises(ValueError):
        R.raster_fused_groups(counts, recs, 64, 1, 3)  # 8 tiles not a multiple of 3
    with pytest.raises(TypeError):
        R.raster_fused_groups_local(counts.float(), recs, 64, 8)
    clist = torch.zeros((1, 8, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        R.raster_chunkskip(counts, clist, recs, 64, 1, 6)  # chunk not in 4, 8, 16, 32
    with pytest.raises(ValueError):
        R.raster_chunkskip(counts, clist, recs[:, :250].contiguous(), 64, 1, 8)
