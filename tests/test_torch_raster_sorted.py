"""PyTorch port vs the JAX package: the tile-sorted schedule (K10) of
`rasterize_normals_fused(sort_tiles=True)`, its group windows and its
tile-local records.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances: those of `test_torch_raster_sched.py`, whose scenes and
checks this file shares.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.render import rasterizer as TR
from test_torch_raster_sched import (SCHED_SCENES, T, close_to_jax, p2f_by_tie_rule,
                                     random_mesh, sched_scene)
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

@pytest.mark.parametrize("scene", SCHED_SCENES)
@pytest.mark.parametrize("tps", [None, 16])
def test_sort_tiles_matches_jax(scene, tps):
    """K10's plain version against JAX's sort_tiles raster and against the
    port's padded path (the tie rule; depth and normals within rounding of
    the rebased records); sort_tiles with compact raises in both."""
    fv, fn, size, cap = sched_scene(scene)
    out = TR.rasterize_normals_fused(T(fv), T(fn), size, cap, sort_tiles=True, tps=tps)
    ref = JR.rasterize_normals_fused(jnp.asarray(fv), jnp.asarray(fn), size, capacity=cap,
                                     interpret=True, sort_tiles=True, tps=tps)
    p2f_by_tie_rule(out, ref, fv, size)
    close_to_jax(out, ref)
    pad = TR.rasterize_normals_fused(T(fv), T(fn), size, cap)
    p2f_by_tie_rule(out, pad, fv, size)
    close_to_jax(out, pad)
    with pytest.raises(ValueError, match="sort_tiles"):
        TR.rasterize_normals_fused(T(fv), T(fn), size, cap, sort_tiles=True, compact=16)
    with pytest.raises(ValueError, match="sort_tiles"):
        JR.rasterize_normals_fused(jnp.asarray(fv), jnp.asarray(fn), size, capacity=cap,
                                   interpret=True, sort_tiles=True, compact=16)


def test_group_walk_and_tile_local_records():
    """The merged schedule's windows run to each group's largest count; the
    tile-local records evaluated at local centres equal the absolute ones
    within rounding; the sorted order puts empty tiles last."""
    counts = torch.tensor([[3, 40, 0, 0, 70, 1, 0, 0]], dtype=torch.int32)
    s, e = TR.group_windows(counts, 4, 4)
    assert s.tolist() == [[0, 4, 8, 12, 16, 20, 24, 28]]
    assert (e - s).tolist() == [[2, 2, 2, 2, 3, 3, 3, 3]]
    assert TR.MERGED_TPS == 8
    bins = torch.zeros((1, 50, 32), dtype=torch.int32)
    pb, pc = TR._pad_tiles_to(bins, torch.ones((1, 50), dtype=torch.int32), 16)
    assert pb.shape == (1, 64, 32) and int(pc[0, 50:].sum()) == 0
    assert bool((pb[0, 50:] == -1).all())
    sc, _, inv = TR.sorted_tiles(torch.zeros((1, 4, 32)), torch.full((1, 8, 32), -1),
                                 counts, 64)
    assert sc.tolist() == [[70, 40, 3, 1, 0, 0, 0, 0]]
    assert torch.equal(torch.gather(sc, 1, inv), counts)
    fv, fn = random_mesh(np.random.default_rng(3), F=4, B=1)
    rec = TR.fused_records(T(fv), T(fn))  # (1,4,32)
    size, tx = 300, 3
    tids = torch.tensor([[0, 4, 7, 11]])
    local = TR._tilelocal_adjust(rec[:, None].expand(1, 4, 4, 32), tids, size, tx)
    xl, yl = TR._tile_centers(1, size, tx, "cpu", local=True)
    xa, ya = TR._tile_centers(12, size, tx, "cpu")
    for i, t in enumerate(tids[0].tolist()):
        for lanes in ((0, 1, 2), (9, 10, 11), (16, 19, 22)):
            want = TR._affine(rec[0, :, None], *lanes, xa[t], ya[t])
            got = TR._affine(local[0, i, :, None], *lanes, xl[0], yl[0])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
