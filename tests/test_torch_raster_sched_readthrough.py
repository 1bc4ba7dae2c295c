"""K9 and K10 read their records through the bins: their plain versions
over (counts, bins[, order], records) equal, bitwise, the plain walk over
the packed route the TPU takes, a per-tile record list gathered from the
padded bins (K9) or from the count-sorted bins and rebased to tile-local
coordinates (K10, `sorted_tiles`); `rasterize_normals_fused(sort_tiles=True)`
un-permutes K10's rows to K1b's tiles. Scenes: the procedural head's face
region at 224 px and the JAX package's merged-loop scene at 64 px.
"""
import numpy as np
import pytest
import torch

from smirk_tpu_torch.render import rasterizer as R
from test_torch_raster_cull_fused import head
from test_torch_raster_sched import random_mesh
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def scene(name):
    """-> (face_verts, face_normals, image size, capacity)."""
    if name == "head224":
        r, fv, fn = head(2, 224, 5)
        return fv, fn, 224, r.bin_capacity
    fv, fn = random_mesh(np.random.default_rng(11), F=80)
    return torch.from_numpy(fv), torch.from_numpy(fn), 64, 64


@pytest.mark.parametrize("name,tps", [("head224", 8), ("random64", 16)])
def test_groups_read_through_matches_packed_route(name, tps):
    fv, fn, size, cap = scene(name)
    tx = -(-size // R.TILE_COLS)
    records = R.fused_records(fv, fn)
    bins, counts = R._pad_tiles_to(*R.bin_faces_flat(fv, size, cap), tps)
    B, Tp, C = bins.shape
    windows = R.group_windows(counts, C // R.V3_CHUNK, tps)
    assert bool((windows[1] - windows[0] > (counts + 31) // 32).any())  # kill steps
    k9 = R.raster_fused_groups(counts, bins, records, fv, image_size=size, tiles_x=tx,
                               tps=tps)  # CPU: the plain version
    packed = R._fused_plain(*windows, R._gather_recs(records, bins.reshape(B, -1)), size, tx)
    for a, b in zip(k9, packed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float((k9[0] >= 0).float().mean()) > 0.02
    sc, sb, order, inv = R.sort_tiles_order(bins, counts)
    assert order.dtype == torch.int32 and torch.equal(torch.gather(sc, 1, inv), counts)
    k10 = R.raster_fused_groups_local(sc, sb, order, records, fv, image_size=size,
                                      tiles_x=tx, tps=tps)
    pc, precs, pinv = R.sorted_tiles(records, bins, counts, size)
    assert torch.equal(pc, sc) and torch.equal(pinv, inv)
    packed = R._fused_plain(*R.group_windows(pc, C // R.V3_CHUNK, tps), precs, size, tx,
                            local=True)
    for a, b in zip(k10, packed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the entry point un-permutes K10's rows: the same z-buffer as K1b's up
    # to the rebase's rounding (test_torch_raster_sorted.py holds it to K1b)
    normals, p2f, zbuf = R.rasterize_normals_fused(fv, fn, size, cap, sort_tiles=True,
                                                   tps=tps)
    rows = [torch.gather(o, 1, inv[..., None].expand_as(o)) for o in k10]
    assert torch.equal(p2f, R._tiles_to_image(rows[0], size))
    assert torch.equal(zbuf, R._tiles_to_image(rows[1], size))
    assert torch.equal(normals[..., 0], R._tiles_to_image(rows[2], size))
