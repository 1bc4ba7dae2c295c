"""PyTorch port vs the JAX package: `bin_chunks` with `_pad_faces_offscreen`,
and the backface cull on `bin_faces_flat` and `bin_chunks`.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances: those of `test_torch_raster_sched.py`, whose scenes and
checks this file shares.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.render import rasterizer as TR
from test_torch_raster_sched import T, chunky_scene, random_mesh
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

@pytest.mark.parametrize("chunk,cap", [(4, 8), (8, 16), (8, 3), (16, 2)])
def test_bin_chunks_matches_jax_exactly(chunk, cap):
    """clist, counts and dropped equal JAX's bin_chunks, including drops
    past a small cap, on the padded face list."""
    fv, _ = chunky_scene(np.random.default_rng(3), B=2, F=56)
    fvp, pad = TR._pad_faces_offscreen(T(fv), chunk)
    fvj, padj = JR._pad_faces_offscreen(jnp.asarray(fv), chunk)
    assert pad == padj
    np.testing.assert_array_equal(fvp.numpy(), np.asarray(fvj))
    got = TR.bin_chunks(fvp, 64, chunk, cap)
    want = JR.bin_chunks(fvj, 64, chunk, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cap <= 3:
        assert int(got[2].sum()) > 0
    with pytest.raises(ValueError, match="multiple"):
        TR.bin_chunks(T(fv[:, :55]), 64, chunk, cap)


@pytest.fixture
def restore_cull():
    """Leave both packages' backface cull switches off, whatever the test
    set."""
    yield
    TR.set_backface_cull(None)
    JR.set_backface_cull(None)


@pytest.mark.parametrize("sign", [1, -1])
def test_backface_cull_matches_jax(restore_cull, sign):
    """With the cull on, bin_faces_flat and bin_chunks equal JAX's, and the
    culled faces bin nowhere."""
    fv, fn = random_mesh(np.random.default_rng(5), F=60)
    fvp, _ = TR._pad_faces_offscreen(T(fv), 4)
    open_bins, open_counts = TR.bin_faces_flat(T(fv), 32, 64)
    TR.set_backface_cull(sign)
    JR.set_backface_cull(sign)
    bins, counts = TR.bin_faces_flat(T(fv), 32, 64)
    bj, cj = JR.bin_faces_flat(jnp.asarray(fv), 32, 64)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cj))
    assert int(counts.sum()) < int(open_counts.sum())
    x, y = fv[..., 0].astype(np.float64), fv[..., 1].astype(np.float64)
    area2 = (x[..., 0] * (y[..., 1] - y[..., 2]) + x[..., 1] * (y[..., 2] - y[..., 0])
             + x[..., 2] * (y[..., 0] - y[..., 1]))
    for b in range(fv.shape[0]):
        kept = set(bins[b][bins[b] >= 0].tolist())
        assert all(area2[b, f] * sign > 0 for f in kept)
    for a, w in zip(TR.bin_chunks(fvp, 32, 4, 8),
                    JR.bin_chunks(jnp.asarray(fvp.numpy()), 32, 4, 8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        TR.set_backface_cull(2)
