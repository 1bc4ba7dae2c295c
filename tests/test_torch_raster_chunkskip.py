"""PyTorch port vs the JAX package: the chunk-skip raster (K11,
`rasterize_normals_chunkskip`) and `spatial_face_order`.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances: those of `test_torch_raster_sched.py`, whose scenes and
checks this file shares.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as TR
from smirk_tpu_torch.render.renderer import Renderer
from test_torch_raster import ROUNDING, _centres, _interp
from test_torch_raster_sched import T, chunky_scene, close_to_jax, p2f_by_tie_rule
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

CHUNKS = [4, 8, 16]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunkskip_matches_jax(chunk):
    """K11's plain version against JAX's chunk-skip raster, and against the
    port's exact fused raster (equal pix_to_face on this scene, as the JAX
    package's own test holds), with F not a multiple of the chunk."""
    fv, fn = chunky_scene(np.random.default_rng(0))
    S = 64
    out = TR.rasterize_normals_chunkskip(T(fv), T(fn), S, chunk=chunk, cap=32,
                                         return_overflow=True)
    ref = JR.rasterize_normals_chunkskip(jnp.asarray(fv), jnp.asarray(fn), S, chunk=chunk,
                                         cap=32, interpret=True, return_overflow=True)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[3].tolist() == [0, 0, 0]
    p2f_by_tie_rule(out, ref, fv, S)
    close_to_jax(out, ref)
    base = TR.rasterize_normals_fused(T(fv), T(fn), S, 64)
    assert (base[1].numpy() >= 0).mean() > 0.1
    np.testing.assert_array_equal(out[1].numpy(), base[1].numpy())
    close_to_jax(out, base)


def test_chunkskip_permuted_input_keeps_original_ids():
    """A spatial_face_order permutation of the inputs with face_ids=perm
    gives the unpermuted pix_to_face, as in JAX; the padding faces (id -1)
    never win."""
    rng = np.random.default_rng(1)
    S = 64
    fv, fn = chunky_scene(rng)
    cent = rng.normal(size=(fv.shape[1] * 3, 3))
    tri = np.arange(fv.shape[1] * 3).reshape(fv.shape[1], 3)
    perm = TR.spatial_face_order(cent, tri)
    np.testing.assert_array_equal(perm, JR.spatial_face_order(cent, tri))
    base = TR.rasterize_normals_fused(T(fv), T(fn), S, 64)
    out = TR.rasterize_normals_chunkskip(T(fv[:, perm]), T(fn[:, perm]), S, chunk=8,
                                         cap=32, face_ids=T(perm))
    ref = JR.rasterize_normals_chunkskip(jnp.asarray(fv[:, perm]), jnp.asarray(fn[:, perm]),
                                         S, chunk=8, cap=32, interpret=True,
                                         face_ids=jnp.asarray(perm))
    np.testing.assert_array_equal(out[1].numpy(), base[1].numpy())
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert out[1].numpy().min() == -1 and out[1].numpy().max() < fv.shape[1]


def test_chunkskip_overflow_drops_farthest_and_reports():
    """An overfilled tile: cap overflow drops the farthest chunks, the
    nearest face still wins, and the drop count equals JAX's; pix_to_face
    equals JAX's by the tie rule (the diagonal edge of the faces runs
    through pixel centres)."""
    B, F, S, CH = 1, 64, 32, 8
    xy = np.tile(np.asarray([[-0.9, -0.9], [-0.2, -0.9], [-0.55, -0.55]], np.float32),
                 (B, F, 1, 1))
    z = (1.0 + np.arange(F, dtype=np.float32) * 0.1)[None, :, None, None]
    fv = np.concatenate([xy, np.broadcast_to(z, (B, F, 3, 1))], -1)
    fn = np.ones((B, F, 3, 3), np.float32)
    full = TR.rasterize_normals_chunkskip(T(fv), T(fn), S, chunk=CH, cap=F // CH,
                                          return_overflow=True)
    clipped = TR.rasterize_normals_chunkskip(T(fv), T(fn), S, chunk=CH, cap=2,
                                             return_overflow=True)
    ref = JR.rasterize_normals_chunkskip(jnp.asarray(fv), jnp.asarray(fn), S, chunk=CH,
                                         cap=2, interpret=True, return_overflow=True)
    assert full[3].tolist() == [0]
    assert int(clipped[3].sum()) > 0
    np.testing.assert_array_equal(clipped[3].numpy(), np.asarray(ref[3]))
    cov = full[1].numpy() >= 0
    assert cov.any()
    np.testing.assert_array_equal(clipped[1].numpy()[cov], 0)
    np.testing.assert_array_equal(clipped[1].numpy(), full[1].numpy())
    # the faces' diagonal edge runs through pixel centres: every pixel where
    # the port and JAX differ lies on it (the 0.1 % cap of the tie rule
    # does not fit one 32 px image with a 32-pixel edge tie)
    x, y = _centres(S)
    for _, r, c in np.argwhere(clipped[1].numpy() != np.asarray(ref[1])):
        e, sc, _, _ = _interp(fv[0, 0], fv[0, 0, :, 2], x[0, c], y[r, 0])
        assert (np.abs(e) <= ROUNDING * sc).any(), (r, c)


def test_spatial_face_order_matches_jax_on_the_template():
    """The Morton order of the template's face region equals JAX's bit for
    bit (a permutation of the faces)."""
    bundle = procedural_bundle(seed=1, full_size=True)
    r = Renderer(bundle, image_size=64, device="cpu")
    vt = np.asarray(bundle["v_template"])[r.kept_vertices]
    faces = r.faces.numpy()
    perm = TR.spatial_face_order(vt, faces)
    np.testing.assert_array_equal(perm, JR.spatial_face_order(vt, faces))
    assert sorted(perm.tolist()) == list(range(len(faces)))
