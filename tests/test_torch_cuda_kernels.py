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
    vals, _, p2f, _ = R.rasterize(fvg, fng, size, cap, r.raster_compact)
    w = torch.randn(vals.shape, device=card, generator=torch.Generator(device=card).manual_seed(1))
    d_fv, d_fn = torch.autograd.grad((vals * w).sum(), (fvg, fng))
    fvc, fnc = fv.cpu().requires_grad_(True), fn.cpu().requires_grad_(True)
    vc, _, pc, _ = R.rasterize(fvc, fnc, size, cap, r.raster_compact)
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
        R.segment_moments(slots, g, 4096, 64)  # accumulators past 48 KB
    with pytest.raises(ValueError):
        R.fold_slots_to_faces(g[..., :32, :].contiguous(), slots[..., :16], 10)
    starts = torch.zeros((1, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        R.raster_planes_windows(starts, starts, torch.zeros((1, 32, 32), device=card), 64, 1, 7)
