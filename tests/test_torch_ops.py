"""PyTorch port vs the JAX package: the op namespace (`smirk_tpu_torch.ops`
against `smirk_tpu.ops`), point and spherical-harmonics shading, and a
small op path: FLAME -> `ops.rasterize` with D = 9 attributes [gray albedo
| world position | normal] -> point and SH shading -> an L2 loss ->
gradients to the expression parameters.

Inputs come from numpy seeds; the JAX side runs its Pallas kernels in
interpret mode on the CPU, the port its kernels' plain versions.

Tolerances. Shading: rtol 1e-6 (plus atol 1e-6 for values near 0), the
same elementwise formulas in both packages. The op path: pix_to_face equal
(the seed is one where it agrees exactly); the shaded image within 1e-5
absolute (fp32 interpolation of positions ~0.1 and unit normals, XLA's FMA
contraction against the port's rounded products); the loss within rtol
1e-5; the expression gradient within 1e-3 x its largest element, as
test_torch_raster_diff.py holds the renderer's vertex gradient: it sums
thousands of per-pixel terms through vertex normals and LBS in another
order in each package.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smirk_tpu.ops as jops
import smirk_tpu_torch.ops as tops
from smirk_tpu.flame import FlameModel as JaxFlame
from smirk_tpu.render import geometry as jgeo
from smirk_tpu.render import shading as jshade
from smirk_tpu_torch.assets import keep_vertices_and_update_faces, procedural_bundle
from smirk_tpu_torch.flame.model import FlameModel
from smirk_tpu_torch.render import shading as tshade
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

Z_OFFSET = 10.0


def T(a):
    return torch.from_numpy(np.array(a))


def public_names(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def test_ops_exports_every_name_of_the_jax_namespace():
    names = public_names(jops)
    assert names == public_names(tops), names ^ public_names(tops)
    assert len(names) == 29
    for n in names:
        assert getattr(tops, n).__module__.startswith("smirk_tpu_torch."), n


def test_point_and_sh_shading_match_jax():
    rng = np.random.default_rng(0)
    B, N, L = 2, 50, 3
    verts = rng.normal(0, 0.1, (B, N, 3)).astype(np.float32)
    normals = rng.normal(0, 1, (B, N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    lpos = rng.normal(0, 2, (B, L, 3)).astype(np.float32)
    lint = rng.uniform(0.5, 2, (B, L, 3)).astype(np.float32)
    got = tops.point_shading(T(verts), T(normals), T(lpos), T(lint))
    want = jops.point_shading(*(jnp.asarray(a) for a in (verts, normals, lpos, lint)))
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    nimg = rng.normal(0, 1, (B, 6, 7, 3)).astype(np.float32)
    sh = rng.normal(0, 1, (B, 9, 3)).astype(np.float32)
    got = tops.sh_shading(T(nimg), T(sh))
    want = jops.sh_shading(jnp.asarray(nimg), jnp.asarray(sh))
    assert got.shape == (B, 6, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tshade.SH_CONST, jshade.SH_CONST)


def _scene(bundle, B, seed):
    rng = np.random.default_rng(seed)
    params = {
        "shape_params": rng.normal(0, 0.5, (B, 300)),
        "expression_params": rng.normal(0, 0.5, (B, 50)),
        "pose_params": rng.normal(0, 0.05, (B, 3)),
        "jaw_params": np.abs(rng.normal(0, 0.05, (B, 3))),
        "eyelid_params": rng.uniform(0, 1, (B, 2)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    faces, kept = keep_vertices_and_update_faces(
        np.asarray(bundle["faces"], np.int64), np.asarray(bundle["face_vertex_ids"]))
    inc = jgeo.build_vertex_face_incidence(faces, len(kept))
    centre = np.asarray(bundle["v_template"])[kept].mean(0)
    cam = np.tile(np.array([[7.0, -centre[0], -centre[1]]], np.float32), (B, 1))
    lights = (np.tile(np.array([[[-1.0, 1.0, 1.0], [1.0, 1.0, 2.0]]], np.float32), (B, 1, 1)),
              np.full((B, 2, 3), 1.5, np.float32))
    sh = rng.normal(0, 0.3, (B, 9, 3)).astype(np.float32)
    return params, faces, kept, inc, cam, lights, sh


def _op_path(ops, xp, geo_faces, kept, inc, vertices, cam, lights, sh, size, cap):
    """FLAME vertices -> D=9 raster -> albedo * (point + SH shading) * mask,
    written once for both packages (`ops` their namespace, `xp` their array
    module)."""
    tv = ops.orth_proj_ndc(vertices, cam)[:, kept]
    tv = xp.concatenate([tv[..., :2], tv[..., 2:] + Z_OFFSET], -1)
    sub_v = vertices[:, kept]
    normals = ops.vertex_normals_gather(sub_v, geo_faces, *inc)
    fv = ops.face_vertices(tv, geo_faces)
    fn = ops.face_vertices(normals, geo_faces)
    albedo = xp.zeros_like(fn) + jshade.GRAY_ALBEDO
    attrs = xp.concatenate([albedo, ops.face_vertices(sub_v, geo_faces), fn], -1)
    vals, mask, p2f, overflow = ops.rasterize(fv, attrs, size, cap)
    B = vals.shape[0]
    pos, nrm = vals[..., 3:6], vals[..., 6:9]
    point = ops.point_shading(pos.reshape(B, -1, 3), nrm.reshape(B, -1, 3), *lights)
    shade = point.reshape(B, size, size, 3) + ops.sh_shading(nrm, sh)
    return vals[..., :3] * shade * mask, p2f, overflow


def test_op_path_matches_jax():
    bundle = procedural_bundle(seed=1, full_size=False)
    B, size, cap = 2, 48, 96
    params, faces, kept, inc, cam, lights, sh = _scene(bundle, B, 4)
    target = np.random.default_rng(5).random((B, size, size, 3)).astype(np.float32)

    jflame = JaxFlame(bundle)

    def jloss(expr):
        p = {k: jnp.asarray(v) for k, v in params.items()}
        p["expression_params"] = expr
        verts = jflame(p)["vertices"]
        img, p2f, ovf = _op_path(
            jops, jnp, jnp.asarray(faces), jnp.asarray(kept),
            tuple(jnp.asarray(a) for a in inc), verts, jnp.asarray(cam),
            tuple(jnp.asarray(a) for a in lights), jnp.asarray(sh), size, cap)
        return jnp.mean((img - target) ** 2), (img, p2f, ovf)

    (lj, (img_j, p2f_j, ovf_j)), gj = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(params["expression_params"]))

    flame = FlameModel(bundle, device="cpu")
    p = {k: T(v) for k, v in params.items()}
    expr = p["expression_params"].requires_grad_(True)
    verts = flame(p)["vertices"]
    img, p2f, ovf = _op_path(
        tops, torch, T(faces), T(kept), tuple(T(a.astype(np.int64)) for a in inc),
        verts, T(cam), tuple(T(a) for a in lights), T(sh), size, cap)
    loss = ((img - T(target)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, expr)

    np.testing.assert_array_equal(p2f.numpy(), np.asarray(p2f_j))
    assert (p2f.numpy() >= 0).mean() > 0.05
    assert ovf.tolist() == np.asarray(ovf_j).tolist() == [0] * B
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    gj = np.asarray(gj)
    assert np.isfinite(g.numpy()).all() and np.abs(gj).max() > 0
    diff = np.abs(g.numpy() - gj).max()
    assert diff <= 1e-3 * np.abs(gj).max(), (diff, np.abs(gj).max())


@pytest.mark.parametrize("name", ["rasterize_coverage_pallas", "rasterize_coverage_pallas_v3"])
def test_coverage_entry_points_on_the_face_region(name):
    """The coverage entry points of both namespaces on the procedural head's
    face region at 64 px: pix_to_face equal and covering the face."""
    bundle = procedural_bundle(seed=1, full_size=False)
    params, faces, kept, _, cam, _, _ = _scene(bundle, 1, 6)
    verts = FlameModel(bundle, device="cpu")({k: T(v) for k, v in params.items()})["vertices"]
    tv = tops.orth_proj_ndc(verts, T(cam))[:, kept]
    tv = torch.cat([tv[..., :2], tv[..., 2:] + Z_OFFSET], -1)
    fv = tops.face_vertices(tv, T(faces))
    pt, _ = getattr(tops, name)(fv, 64, 128)
    pj, _ = getattr(jops, name)(jnp.asarray(fv.detach().numpy()), 64, capacity=128,
                                interpret=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert (pt.numpy() >= 0).mean() > 0.05
