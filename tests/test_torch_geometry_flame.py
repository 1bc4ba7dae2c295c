"""PyTorch port vs the JAX package: FLAME, camera, geometry, shading, the
procedural bundle, the port's import boundary and its device rule.

Inputs come from numpy seeds and go through the JAX function and its port
counterpart on the CPU.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.flame import FlameModel as JaxFlame
from smirk_tpu.flame import lbs as jlbs
from smirk_tpu.render import camera as jcam
from smirk_tpu.render import geometry as jgeo
from smirk_tpu.render import shading as jshade
from smirk_tpu_torch import assets as tassets
from smirk_tpu_torch.flame import lbs as tlbs
from smirk_tpu_torch.flame.model import FlameModel
from smirk_tpu_torch.render import camera as tcam
from smirk_tpu_torch.render import geometry as tgeo
from smirk_tpu_torch.render import shading as tshade
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = np.load(os.path.join(ROOT, "tests", "fixtures", "lbs_golden.npz"))
TOL = dict(rtol=1e-5, atol=1e-5)


def T(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def small_bundle():
    return tassets.procedural_bundle(seed=3, full_size=False)


# ----------------------------- golden fixtures -----------------------------


def test_lbs_golden_pieces():
    """Port vs the reference outputs stored in lbs_golden.npz."""
    np.testing.assert_allclose(
        tlbs.batch_rodrigues(T(FIX["rodrigues_in"])), FIX["rodrigues_out"], **TOL)
    np.testing.assert_allclose(
        tlbs.blend_shapes(T(FIX["bs_betas"]), T(FIX["bs_disps"])), FIX["bs_out"], **TOL)
    np.testing.assert_allclose(
        tlbs.vertices2joints(T(FIX["v2j_Jr"]), T(FIX["v2j_verts"])), FIX["v2j_out"], **TOL)
    posed, rel = tlbs.batch_rigid_transform(
        T(FIX["brt_rots"]), T(FIX["brt_joints"]), FIX["brt_parents"])
    np.testing.assert_allclose(posed, FIX["brt_posed"], **TOL)
    np.testing.assert_allclose(rel, FIX["brt_rel"], **TOL)
    verts, joints = tlbs.lbs(
        T(FIX["bs_betas"]), T(FIX["lbs_pose"]), T(FIX["lbs_v_template"]),
        T(FIX["bs_disps"]), T(FIX["lbs_posedirs"]), T(FIX["v2j_Jr"]),
        FIX["brt_parents"], T(FIX["lbs_W"]))
    np.testing.assert_allclose(verts, FIX["lbs_verts"], **TOL)
    np.testing.assert_allclose(joints, FIX["lbs_joints"], **TOL)
    lm = tlbs.vertices2landmarks(
        T(FIX["v2j_verts"]), T(FIX["v2l_faces"].astype(np.int64)),
        T(FIX["v2l_idx"].astype(np.int64)), T(FIX["v2l_bary"]))
    np.testing.assert_allclose(lm, FIX["v2l_out"], **TOL)


def test_camera_and_geometry_golden():
    faces = T(FIX["v2l_faces"].astype(np.int64))
    verts = T(FIX["v2j_verts"])
    np.testing.assert_allclose(
        tcam.batch_orth_proj(verts, T(FIX["orth_cam"])), FIX["orth_out"], **TOL)
    np.testing.assert_allclose(tgeo.face_vertices(verts, faces), FIX["fv_out"], **TOL)
    np.testing.assert_allclose(
        tgeo.vertex_normals(verts, faces), FIX["vn_out"], rtol=1e-4, atol=1e-4)


def test_dynamic_contour_lut_golden():
    """Pose-dependent jaw-contour selection (round half to even, upper-only
    clip) vs the reference outputs in dynlmk_golden.npz."""
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", "dynlmk_golden.npz"))
    f_idx, bary = tlbs.find_dynamic_lmk_idx_and_bcoords(
        T(fix["pose"]), T(fix["dyn_faces"].astype(np.int64)), T(fix["dyn_bary"]),
        fix["neck_chain"])
    np.testing.assert_array_equal(f_idx.numpy(), fix["out_faces"])
    np.testing.assert_allclose(bary.numpy(), fix["out_bary"], atol=1e-6)


# ------------------------------ port vs JAX ------------------------------


def test_rodrigues_and_lut_vs_jax_at_zero_and_ties():
    """The +1e-8 inside the norm at zero rotation, both roundings half to
    even, and LUT angles across both clip boundaries agree with the JAX
    package exactly in index."""
    rng = np.random.default_rng(0)
    rv = np.concatenate([np.zeros((2, 3)), rng.normal(0, 1, (30, 3))]).astype(np.float32)
    np.testing.assert_allclose(
        tlbs.batch_rodrigues(T(rv)), np.asarray(jlbs.batch_rodrigues(jnp.asarray(rv))),
        rtol=1e-6, atol=1e-6)
    halves = np.arange(-41.5, 42.0, 1.0, dtype=np.float32)
    np.testing.assert_array_equal(torch.round(T(halves)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(halves))))
    # y rotations of the neck chain over [-60, 60] degrees, kept 0.2 deg
    # off the .5 bin edges, where a last-ulp difference of atan2 between
    # the two libraries would pick the neighbouring bin
    ang = np.deg2rad(np.arange(-60.0, 60.5, 0.5) + 0.2).astype(np.float32)
    pose = np.zeros((len(ang), 15), np.float32)
    pose[:, 1] = ang
    dyn_f = rng.integers(0, 100, (79, 17)).astype(np.int32)
    dyn_b = rng.dirichlet(np.ones(3), (79, 17)).astype(np.float32)
    chain = np.array([1, 0])
    jf, jb = jlbs.find_dynamic_lmk_idx_and_bcoords(
        jnp.asarray(pose), jnp.asarray(dyn_f), jnp.asarray(dyn_b), chain)
    tf, tb = tlbs.find_dynamic_lmk_idx_and_bcoords(T(pose), T(dyn_f), T(dyn_b), chain)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("mode", ["plain", "zero_expression", "zero_shape", "zero_pose"])
def test_flame_matches_jax(small_bundle, mode):
    rng = np.random.default_rng(5)
    B = 3
    params = {
        "shape_params": rng.normal(0, 1, (B, 300)),
        "expression_params": rng.normal(0, 1, (B, 40)),  # padded to 50
        "pose_params": rng.normal(0, 0.2, (B, 3)),
        "jaw_params": np.abs(rng.normal(0, 0.1, (B, 3))),
        "eyelid_params": rng.uniform(0, 1, (B, 2)),
        "neck_pose_params": rng.normal(0, 0.2, (B, 3)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    flags = {} if mode == "plain" else {mode: True}
    ref = JaxFlame(small_bundle)({k: jnp.asarray(v) for k, v in params.items()}, **flags)
    out = FlameModel(small_bundle, device="cpu")(
        {k: T(v) for k, v in params.items()}, **flags)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_camera_geometry_shading_match_jax(small_bundle):
    rng = np.random.default_rng(9)
    B = 2
    verts = (small_bundle["v_template"][None]
             + rng.normal(0, 1e-3, (B,) + small_bundle["v_template"].shape)).astype(np.float32)
    cam = np.array([[7.0, 0.01, -0.02], [6.5, -0.03, 0.0]], np.float32)
    faces = small_bundle["faces"]
    lmk = rng.normal(0, 0.05, (B, 68, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcam.orth_proj_ndc(T(verts), T(cam)).numpy(),
        np.asarray(jcam.orth_proj_ndc(jnp.asarray(verts), jnp.asarray(cam))))
    np.testing.assert_array_equal(
        tcam.project_landmarks(T(lmk), T(cam)).numpy(),
        np.asarray(jcam.project_landmarks(jnp.asarray(lmk), jnp.asarray(cam))))
    fidx, cidx = tgeo.build_vertex_face_incidence(faces, len(verts[0]))
    jfidx, jcidx = jgeo.build_vertex_face_incidence(faces, len(verts[0]))
    np.testing.assert_array_equal(fidx, jfidx)
    np.testing.assert_array_equal(cidx, jcidx)
    ft = T(faces.astype(np.int64))
    n_port = tgeo.vertex_normals_gather(T(verts), ft, T(fidx), T(cidx)).numpy()
    n_jax = np.asarray(jgeo.vertex_normals_gather(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(jfidx), jnp.asarray(jcidx)))
    np.testing.assert_allclose(n_port, n_jax, atol=1e-6)
    np.testing.assert_allclose(
        tgeo.vertex_normals(T(verts), ft).numpy(), n_jax, atol=2e-5)
    np.testing.assert_array_equal(
        tgeo.face_vertices(T(verts), ft).numpy(),
        np.asarray(jgeo.face_vertices(jnp.asarray(verts), jnp.asarray(faces))))
    nimg = rng.normal(0, 1, (B, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tshade.directional_shading(T(nimg), T(tshade.unit_directions())).numpy(),
        np.asarray(jshade.directional_shading(jnp.asarray(nimg))), atol=1e-6)
    assert tshade.GRAY_ALBEDO == jshade.GRAY_ALBEDO


def test_procedural_bundle_shapes():
    """FLAME's counts and every key FlameModel / Renderer / SmirkSystem read."""
    b = tassets.procedural_bundle(seed=0, full_size=True)
    V = b["v_template"].shape[0]
    F = b["faces"].shape[0]
    assert abs(V - 5023) < 10 and abs(F - 9976) < 100
    assert len(b["face_vertex_ids"]) == 1787
    sub, _ = tassets.keep_vertices_and_update_faces(b["faces"], b["face_vertex_ids"])
    assert len(sub) == 3408
    extent = b["v_template"].max(0) - b["v_template"].min(0)
    np.testing.assert_allclose(extent, [0.15, 0.2, 0.18], atol=0.015)
    shapes = {
        "shapedirs": (V, 3, 400), "posedirs": (36, 3 * V), "J_regressor": (5, V),
        "lbs_weights": (V, 5), "parents": (5,), "l_eyelid": (V, 3),
        "r_eyelid": (V, 3), "static_lmk_faces_idx": (51,),
        "static_lmk_bary_coords": (51, 3), "dynamic_lmk_faces_idx": (79, 17),
        "dynamic_lmk_bary_coords": (79, 17, 3), "full_lmk_faces_idx": (68,),
        "full_lmk_bary_coords": (68, 3), "mp_lmk_faces_idx": (105,),
        "mp_lmk_bary_coords": (105, 3), "face_probabilities": (F,),
    }
    for k, s in shapes.items():
        assert b[k].shape == s, k
    b2 = tassets.procedural_bundle(seed=0, full_size=True)
    for k in shapes:
        np.testing.assert_array_equal(b[k], b2[k])
    small = tassets.procedural_bundle(seed=0, full_size=False)
    assert 200 <= small["faces"].shape[0] <= 1000


# ------------------------ import boundary, devices ------------------------


def _python_files():
    pkg = os.path.join(ROOT, "smirk_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax():
    """Nothing in smirk_tpu_torch/ or chip_smoke.py imports jax, flax,
    optax, scipy or the JAX package; chip_smoke.py imports no PIL itself:
    it reads and writes image files through the port's own `utils.viz` and
    `cli.demo_video`, so that those readers and writers are what it runs."""
    banned = {"jax", "jaxlib", "flax", "optax", "scipy", "smirk_tpu"}
    found = []
    for path in _python_files():
        if path.endswith("chip_smoke.py"):
            banned = banned | {"PIL"}
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            found += [(path, n) for n in names if n.split(".")[0] in banned]
    assert not found, found


def test_entry_points_raise_without_card(monkeypatch, small_bundle):
    """Without a card and without device='cpu' the entry points raise; they
    never fall back to the CPU."""
    from smirk_tpu_torch import Predictor
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.render.renderer import Renderer
    from smirk_tpu_torch.train import SmirkSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(bundle=small_bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SmirkSystem(Config(), small_bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(small_bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlameModel(small_bundle)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlameModel(small_bundle, device="cuda")
