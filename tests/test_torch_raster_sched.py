"""PyTorch port vs the JAX package: the scheduled inference rasters, the
merged schedule (K9) of `rasterize_normals_fused` and its keyword-only
tail; the shared scenes and checks of the slice's test files.

The slice's tests sit in files of at most six tests:
`test_torch_raster_sched.py` (merged), `_sorted` (sort_tiles, K10),
`_chunkskip` (K11 and `spatial_face_order`), `test_torch_bin_chunks.py`
(`bin_chunks` and the backface cull) and `test_torch_raster_slice.py`
(the slice end to end). `--dist loadfile` hands files out in order of
their test count, so files this small come after `test_models_parity.py`
and leave the order of the files before it as it was: that file's
full-size tests fail on a worker that ran a test module which writes tiny
tables into `mnv3.ARCHS` without a restore (ROADMAP R2).

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances. Bins, chunk lists, counts, drops and the Morton order must be
equal. K9 must equal the port's padded K1b path bit for bit (its extra
steps test kill records only). Against JAX, pix_to_face is held by
`check_p2f_zbuf` (equal except at edge or depth ties, at most 0.1 % of
pixels), depth to rtol 2e-4 / atol 1e-5 and normals to atol 2e-4 / rtol
1e-3 where pix_to_face agrees (the JAX package's own chunk-skip test):
XLA on the CPU contracts the affine forms into fused multiply-adds, the
port rounds every product, and K10's rebased record constants round
differently again.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as TR
from test_torch_raster import check_p2f_zbuf, make_scene
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def random_mesh(rng, F=50, B=2):
    """The JAX package's merged-loop test scene: F triangles of up to 0.4
    NDC, depths 5-15."""
    v0 = rng.uniform(-1, 1, (B, F, 1, 3))
    dv = rng.uniform(-0.4, 0.4, (B, F, 2, 3))
    fv = np.concatenate([v0, v0 + dv], axis=2).astype(np.float32)
    fv[..., 2] = rng.uniform(5, 15, (B, F, 3))
    return fv, rng.normal(0, 1, (B, F, 3, 3)).astype(np.float32)


def chunky_scene(rng, B=3, F=52):
    """The JAX package's chunk-skip test scene: clustered small triangles
    with varied depth; F is not a multiple of the chunk sizes under test."""
    v = rng.uniform(-1.1, 1.1, (B, F, 3, 2)).astype(np.float32)
    c = rng.uniform(-1, 1, (B, F, 1, 2)).astype(np.float32)
    v = c + (v - c) * 0.25
    z = rng.uniform(0.5, 2.0, (B, F, 1, 1)).astype(np.float32) + rng.uniform(
        -0.05, 0.05, (B, F, 3, 1)).astype(np.float32)
    return (np.concatenate([v, z], -1),
            rng.normal(size=(B, F, 3, 3)).astype(np.float32))


def head_scene(B=2, size=64, seed=2):
    r, _, _, fv, fn = make_scene(procedural_bundle(seed=1, full_size=False), size, B, seed)
    return fv.numpy(), fn.numpy(), r.bin_capacity


def T(a):
    return torch.from_numpy(np.asarray(a))


def close_to_jax(out, ref):
    """Depth and normals within the JAX package's chunk-skip tolerances
    where pix_to_face agrees, and where it is empty in both."""
    nt, pt, zt = (o.numpy() for o in out[:3])
    nj, pj, zj = (np.asarray(o) for o in ref[:3])
    agree = pt == pj
    cov = agree & (pt >= 0)
    np.testing.assert_allclose(zt[cov], zj[cov], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(zt[agree & ~cov], zj[agree & ~cov])
    np.testing.assert_allclose(nt[agree], nj[agree], atol=2e-4, rtol=1e-3)


def p2f_by_tie_rule(out, ref, fv, size):
    """check_p2f_zbuf on pix_to_face alone (depth is held separately)."""
    pt = out[1].numpy()
    pj = np.asarray(ref[1])
    zero = np.zeros(pt.shape, np.float32)
    return check_p2f_zbuf(pt, pj, zero, zero, fv, size)


SCHED_SCENES = ["random32", "head64"]


def sched_scene(name):
    if name == "random32":
        fv, fn = random_mesh(np.random.default_rng(11))
        return fv, fn, 32, 64
    fv, fn, cap = head_scene()
    return fv, fn, 64, cap


@pytest.mark.parametrize("scene", SCHED_SCENES)
@pytest.mark.parametrize("tps", [None, 16])
def test_merged_matches_jax_and_padded(scene, tps):
    """K9's plain version: bit for bit the port's padded K1b path, and
    within the tolerances of JAX's merged raster; compact wins over
    merged."""
    fv, fn, size, cap = sched_scene(scene)
    out = TR.rasterize_normals_fused(T(fv), T(fn), size, cap, merged=True, tps=tps)
    pad = TR.rasterize_normals_fused(T(fv), T(fn), size, cap)
    for a, b in zip(out, pad):
        assert torch.equal(a, b)
    ref = JR.rasterize_normals_fused(jnp.asarray(fv), jnp.asarray(fn), size, capacity=cap,
                                     interpret=True, merged=True, tps=tps)
    p2f_by_tie_rule(out, ref, fv, size)
    close_to_jax(out, ref)
    assert (out[1].numpy() >= 0).mean() > 0.05
    comp = TR.rasterize_normals_fused(T(fv), T(fn), size, cap, merged=True, compact=64)
    want = TR.rasterize_normals_fused(T(fv), T(fn), size, cap, compact=64)
    for a, b in zip(comp, want):
        assert torch.equal(a, b)


def test_fused_tail_is_keyword_only():
    """The JAX-style call rasterize_normals_fused(fv, fn, S, C, True), whose
    5th positional argument is JAX's `interpret`, is refused in the port
    instead of running as a compact budget."""
    fv, fn = random_mesh(np.random.default_rng(7), F=10, B=1)
    with pytest.raises(TypeError):
        TR.rasterize_normals_fused(T(fv), T(fn), 32, 64, True)
    out = TR.rasterize_normals_fused(T(fv), T(fn), 32, 64, compact=8, return_overflow=True)
    assert len(out) == 4
