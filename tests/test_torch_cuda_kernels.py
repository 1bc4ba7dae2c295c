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
