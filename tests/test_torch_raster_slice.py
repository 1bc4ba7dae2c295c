"""PyTorch port vs the JAX package: the slice of scheduled inference
rasters end to end, from a FLAME head to merged (K9), sort_tiles (K10)
and chunk-skip (K11).

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrappers take them for CPU tensors).

Tolerances: those of `test_torch_raster_sched.py`, whose scenes and
checks this file shares.
"""
import jax.numpy as jnp
import numpy as np

from smirk_tpu.flame import FlameModel as JaxFlame
from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.flame.model import FlameModel
from smirk_tpu_torch.render import rasterizer as TR
from smirk_tpu_torch.render.renderer import Renderer
from test_torch_raster import check_p2f_zbuf
from test_torch_raster_sched import T, close_to_jax, p2f_by_tie_rule
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

def test_slice_whole_path_matches_jax():
    """The slice end to end: procedural head -> FLAME -> the renderer's face
    geometry -> merged, sort_tiles and chunk-skip (on a Morton-permuted
    face list with the original ids), each against JAX's entry point on the
    same arrays, and against the port's default compact render."""
    bundle = procedural_bundle(seed=1, full_size=False)
    B, S = 2, 64
    rng = np.random.default_rng(4)
    params = {
        "shape_params": rng.normal(0, 0.5, (B, 300)),
        "expression_params": rng.normal(0, 0.5, (B, 50)),
        "pose_params": rng.normal(0, 0.05, (B, 3)),
        "jaw_params": np.abs(rng.normal(0, 0.05, (B, 3))),
        "eyelid_params": rng.uniform(0, 1, (B, 2)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    verts = FlameModel(bundle, device="cpu")({k: T(v) for k, v in params.items()})["vertices"]
    vj = JaxFlame(bundle)({k: jnp.asarray(v) for k, v in params.items()})["vertices"]
    np.testing.assert_allclose(verts.numpy(), np.asarray(vj), atol=1e-5)
    r = Renderer(bundle, image_size=S, device="cpu")
    centre = np.asarray(bundle["v_template"])[r.kept_vertices].mean(0)
    cam = T(np.tile(np.array([[7.0, -centre[0], -centre[1]]], np.float32), (B, 1)))
    fv, fn = r._face_geometry(verts, r.project(verts, cam))
    fvn, fnn = fv.numpy(), fn.numpy()
    cap = r.bin_capacity
    default = r.render_inference(verts, r.project(verts, cam))[2]
    assert (default.numpy() >= 0).mean() > 0.05
    perm = TR.spatial_face_order(np.asarray(bundle["v_template"])[r.kept_vertices],
                                 r.faces.numpy())
    runs = {
        "merged": (lambda: TR.rasterize_normals_fused(fv, fn, S, cap, merged=True),
                   lambda: JR.rasterize_normals_fused(
                       jnp.asarray(fvn), jnp.asarray(fnn), S, capacity=cap,
                       interpret=True, merged=True)),
        "sort_tiles": (lambda: TR.rasterize_normals_fused(fv, fn, S, cap, sort_tiles=True),
                       lambda: JR.rasterize_normals_fused(
                           jnp.asarray(fvn), jnp.asarray(fnn), S, capacity=cap,
                           interpret=True, sort_tiles=True)),
        "chunkskip": (lambda: TR.rasterize_normals_chunkskip(
                          fv[:, perm], fn[:, perm], S, 8, 128, return_overflow=True,
                          face_ids=T(perm)),
                      lambda: JR.rasterize_normals_chunkskip(
                          jnp.asarray(fvn[:, perm]), jnp.asarray(fnn[:, perm]), S, 8, 128,
                          interpret=True, return_overflow=True,
                          face_ids=jnp.asarray(perm))),
    }
    for name, (port, jax_run) in runs.items():
        out, ref = port(), jax_run()
        p2f_by_tie_rule(out, ref, fvn, S)
        close_to_jax(out, ref)
        zero = np.zeros(default.shape, np.float32)
        check_p2f_zbuf(out[1].numpy(), default.numpy(), zero, zero, fvn, S)
        assert all(np.isfinite(o.numpy()).all() for o in out), name
    assert out[3].tolist() == np.asarray(ref[3]).tolist() == [0] * B
