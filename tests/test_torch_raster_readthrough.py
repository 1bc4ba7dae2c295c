"""K1 and K3 read the records through the bins: their plain versions on the
(kept, bins, records) inputs against the packed route the TPU takes (the
compact plan, K2's contract `compact_faces_plain`, a gather of the packed
chunks' records, then the window walk), bitwise, on the CPU.

Both walk the same records in the same order with the same arithmetic, so
pix_to_face, zbuf, the normals, the per-tile slot and the value planes must
be equal bit for bit, at the default budget, at a budget of 8 chunks that
drops chunks (equal overflow), and on the padded layout against the
padded bins gathered whole. A kept count past the bin's chunks is clamped
to them, as in the kernels.
"""
import numpy as np
import pytest
import torch

from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def scene(full, size, B, seed):
    """Jittered procedural head at a random cam around scale 7 -> (renderer,
    face_verts, face_normals) on the CPU."""
    bundle = procedural_bundle(seed=1, full_size=full)
    rng = np.random.default_rng(seed)
    vt = bundle["v_template"]
    verts = torch.from_numpy(
        (vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32))
    cam = torch.from_numpy(np.stack([rng.uniform(6.0, 8.0, B), rng.uniform(-0.05, 0.05, B),
                                     rng.uniform(-0.05, 0.05, B)], 1).astype(np.float32))
    r = Renderer(bundle, image_size=size, device="cpu")
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    return r, fv, fn


def assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def layouts(r, counts):
    """(budget or None, kept, overflow) for the default budget, a budget of
    8 chunks and the padded layout."""
    out = []
    for compact in (r.raster_compact, 8, None):
        kept, overflow = R._windows(counts, compact)
        out.append((compact, kept, overflow))
    return out


def check_layout(compact, kept, overflow, records, bins, counts, walk, read_through):
    """The read-through plain render against the packed (or padded) route."""
    B, Tp, C = bins.shape
    if compact is None:
        starts, ends = R.padded_windows(counts, C // R.V3_CHUNK)
        recs = R._gather_recs(records, bins.reshape(B, -1))
        assert int(overflow.abs().max()) == 0
    else:
        starts, ends, recs, dropped = R.packed_layout_plain(records, bins, counts, compact)
        assert torch.equal(overflow, dropped)
    assert torch.equal(kept, ends - starts)
    assert_equal(read_through, walk(starts, ends, recs))
    return int(overflow.min())


# 100 px: a partial last tile row and column, and padding tiles (13 -> 16)
SCENES = [(False, 64, 2, 0), (False, 100, 2, 5), (True, 224, 1, 3)]


@pytest.mark.parametrize("full,size,B,seed", SCENES)
def test_fused_read_through_matches_packed_route(full, size, B, seed):
    r, fv, fn = scene(full, size, B, seed)
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, r.bin_capacity)
    records = R.fused_records(fv, fn)
    dropped = {}
    for compact, kept, overflow in layouts(r, counts):
        got = R.raster_fused_windows(kept, bins, records, fv, size, TX)  # CPU: plain
        dropped[compact] = check_layout(
            compact, kept, overflow, records, bins, counts,
            lambda s, e, recs: R._fused_plain(s, e, recs, size, TX), got)
        assert bool((got[0] >= 0).any())
    assert dropped[8] > 0  # budget 8 drops chunks in every image
    # a kept count past the bin's C/32 chunks walks the whole bin, as the
    # kernel clamps it
    cpt = bins.shape[2] // R.V3_CHUNK
    assert_equal(R.raster_fused_windows(kept + cpt, bins, records, fv, size, TX),
                 R.raster_fused_windows(torch.full_like(kept, cpt), bins, records, fv, size,
                                        TX))
    _, p2f, _, ovf = R.rasterize_normals_fused(fv, fn, size, r.bin_capacity, compact=8,
                                               return_overflow=True)
    assert torch.equal(ovf, R._compact_plan(counts, 8)[4])


@pytest.mark.parametrize("full,size,B,seed,D", [(False, 64, 2, 1, 1), (False, 100, 2, 6, 3),
                                                (True, 224, 1, 4, 6)])
def test_planes_read_through_matches_packed_route(full, size, B, seed, D):
    r, fv, fn = scene(full, size, B, seed)
    TX = -(-size // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, size, r.bin_capacity)
    attrs = torch.cat([fn, fv, fn * 0.5], -1)[..., :D]
    records = R.planes_records(fv, attrs)
    dropped = {}
    for compact, kept, overflow in layouts(r, counts):
        got = R.raster_planes_windows_plain(kept, bins, records, size, TX, D)
        dropped[compact] = check_layout(
            compact, kept, overflow, records, bins, counts,
            lambda s, e, recs: R._planes_plain(s, e, recs, size, TX, D), got)
        p2f, _, slot, vals = got
        assert vals.shape == (D,) + p2f.shape
        # the slot indexes the tile's bin row: the winner's id is there
        fid = torch.gather(bins.reshape(B, bins.shape[1], -1), 2, slot.clamp_min(0).long())
        assert torch.equal(torch.where(slot >= 0, fid, -1), p2f)
    assert dropped[8] > 0
    # the differentiable raster's forward takes the same path
    vals, _, p2f, ovf = R.rasterize(fv, attrs, size, r.bin_capacity, compact=8)
    assert torch.equal(ovf, R._compact_plan(counts, 8)[4]) and int(ovf.min()) > 0
    assert vals.shape == (B, size, size, D)
