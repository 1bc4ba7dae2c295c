"""The FLAME head the benchmark hands to the program and to the
reference: a frozen copy of `procedural_bundle` and its helpers from
smirk_tpu_torch/assets.py at commit 19e99aba3b04 (the FLAME 2020 files
are licence-gated and absent), and `cam_fix`, the recentring that
smirk_tpu_torch/bench.py applies at the same commit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

N_SHAPE_FULL = 300
N_EXP_FULL = 100
NUM_JOINTS = 5


def synthetic_deformation_tensors(
    n_verts: int,
    faces: np.ndarray,
    v_template: np.ndarray,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Deterministic FLAME-like deformation tensors.

    Used when the license-gated generic_model.pkl is unavailable. Scales are
    chosen so parameter magnitudes ~N(0,1) produce plausible-size (~mm)
    deformations of a head-sized template.
    """
    rng = np.random.default_rng(seed)
    V = n_verts
    P = (NUM_JOINTS - 1) * 9
    shapedirs = rng.normal(0, 1e-3, (V, 3, N_SHAPE_FULL + N_EXP_FULL)).astype(
        np.float32
    )
    posedirs = rng.normal(0, 1e-4, (P, V * 3)).astype(np.float32)
    # Joints at plausible head locations: root/neck near centroid, jaw below,
    # eyes near the eye region (only geometry-plausible, not anatomical).
    c = v_template.mean(0)
    joint_pos = np.stack(
        [
            c,
            c + [0, 0.02, 0],
            c + [0, -0.04, 0.02],
            c + [-0.03, 0.03, 0.04],
            c + [0.03, 0.03, 0.04],
        ]
    ).astype(np.float32)
    # J_regressor: softmax over inverse distances (rows sum to 1).
    d = np.linalg.norm(v_template[None] - joint_pos[:, None], axis=-1)
    Jr = np.exp(-d / 0.01)
    J_regressor = (Jr / Jr.sum(1, keepdims=True)).astype(np.float32)
    # lbs weights: soft assignment to nearest joints.
    w = np.exp(-d.T / 0.05)
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
    parents = np.array([-1, 0, 1, 1, 1], dtype=np.int64)
    return {
        "v_template": v_template.astype(np.float32),
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": J_regressor,
        "parents": parents,
        "lbs_weights": lbs_weights,
        "faces": faces.astype(np.int32),
    }


# FLAME 2020's counts: 5023 vertices; the 'face' region cut that the
# renderer draws keeps 1787 of them.
FLAME_NUM_VERTS = 5023
FLAME_FACE_REGION_VERTS = 1787
# FLAME's physical extent in metres (width, height, depth) ~ 0.15 x 0.2 x 0.15
HEAD_SEMI_AXES = np.array([0.075, 0.1, 0.075])


def _lat_long_ellipsoid(n_lat: int, n_lon: int, rng) -> tuple:
    """Closed ellipsoid (poles on the y axis, front on +z) with a nose bump
    and a little seeded jitter, faces wound outward."""
    theta = np.linspace(0.0, np.pi, n_lat + 2)[1:-1]  # polar angle from +y
    phi = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)  # 0 = front
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack(
        [st * np.sin(phi)[None], np.broadcast_to(ct, (n_lat, n_lon)),
         st * np.cos(phi)[None]], -1
    ).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    verts = unit * HEAD_SEMI_AXES
    # nose: a gaussian bump on the front, centred a little below mid-height
    x, y = verts[:, 0], verts[:, 1]
    bump = 0.03 * np.exp(-((x / 0.012) ** 2 + ((y + 0.005) / 0.03) ** 2))
    verts[:, 2] += np.where(verts[:, 2] > 0, bump, 0.0)
    verts += rng.normal(0.0, 2e-4, verts.shape)

    def v(i, j):
        return 1 + i * n_lon + (j % n_lon)

    faces = []
    last = len(verts) - 1
    for j in range(n_lon):
        faces.append((0, v(0, j), v(0, j + 1)))
        faces.append((last, v(n_lat - 1, j + 1), v(n_lat - 1, j)))
        for i in range(n_lat - 1):
            faces.append((v(i, j), v(i + 1, j), v(i + 1, j + 1)))
            faces.append((v(i, j), v(i + 1, j + 1), v(i, j + 1)))
    faces = np.asarray(faces, np.int64)
    tri = verts[faces]
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    inward = (normal * tri.mean(1)).sum(-1) < 0
    faces[inward] = faces[inward][:, ::-1]
    return verts.astype(np.float32), faces.astype(np.int32), unit


def _smooth_bases(unit: np.ndarray, n: int, scale: float, rng,
                  front_only: bool) -> np.ndarray:
    """(V,3,n) smooth displacement fields over the head, PCA-like: field k
    is a random combination of the monomials of the unit direction up to
    degree 3, normalized to an RMS vertex displacement of scale /
    sqrt(1 + k) per unit parameter; `front_only` fades it out behind the
    face (FLAME's expressions move the face, not the back of the head)."""
    x, y, z = unit.T
    mono = [np.ones_like(x)]
    for deg in range(1, 4):
        for i in range(deg + 1):
            for j in range(deg + 1 - i):
                mono.append(x ** i * y ** j * z ** (deg - i - j))
    basis = np.stack(mono, -1)  # (V,20)
    fields = np.einsum("vm,kdm->vdk", basis, rng.normal(size=(n, 3, basis.shape[1])))
    if front_only:
        fields *= np.clip((z + 0.2) / 1.2, 0.0, 1.0)[:, None, None]
    rms = np.sqrt((fields ** 2).sum(1).mean(0))  # (n,)
    return (fields * (scale / np.sqrt(1.0 + np.arange(n)) / rms)).astype(np.float32)




def procedural_bundle(seed: int = 0, full_size: bool = True) -> Dict:
    """A deterministic head-like FLAME bundle, standing in for the FLAME
    assets (head_template.obj, the landmark embeddings, FLAME_masks, the
    eyelid blendshapes and the license-gated generic_model.pkl), which the
    repository does not ship.

    The mesh is a closed lat-long ellipsoid with a nose, at FLAME's
    physical scale (about 0.15 x 0.2 x 0.15 m). `full_size=True` gives
    FLAME's counts: 5024 vertices and 10044 faces, with a front 'face'
    region of 1787 vertices (about 3400 faces) that the renderer draws.
    `full_size=False` gives a few hundred faces, for tests on the CPU.
    The pose tensors come from `synthetic_deformation_tensors`; the shape
    and expression bases are smooth, PCA-like fields (`_smooth_bases`: 2 mm
    RMS per unit of the first component, decreasing), so that the
    augmented expressions of training (up to +-4) bend the surface as
    FLAME's do instead of scattering its vertices; the landmark embeddings, eyelid blendshapes and per-face sampling
    probabilities are drawn from `seed` on the face region, at the shapes
    the real assets have.
    """
    rng = np.random.default_rng(seed)
    n_lat, n_lon = (62, 81) if full_size else (14, 20)
    verts, faces, unit = _lat_long_ellipsoid(n_lat, n_lon, rng)
    V = len(verts)
    n_region = int(round(V * FLAME_FACE_REGION_VERTS / FLAME_NUM_VERTS))
    # the region is the cap of vertices facing +z the most
    face_vertex_ids = np.sort(np.argsort(-unit[:, 2], kind="stable")[:n_region])
    in_region = np.zeros(V, bool)
    in_region[face_vertex_ids] = True
    region_faces = np.nonzero(in_region[faces].all(1))[0].astype(np.int32)

    bundle = synthetic_deformation_tensors(V, faces, verts, seed=seed)
    brng = np.random.default_rng(seed + 1)
    bundle["shapedirs"] = np.concatenate(
        [_smooth_bases(unit, N_SHAPE_FULL, 2e-3, brng, front_only=False),
         _smooth_bases(unit, N_EXP_FULL, 2e-3, brng, front_only=True)], axis=2)

    def lmk(*shape):
        idx = rng.choice(region_faces, size=shape).astype(np.int32)
        bary = rng.dirichlet(np.ones(3), size=shape).astype(np.float32)
        return idx, bary

    (bundle["static_lmk_faces_idx"],
     bundle["static_lmk_bary_coords"]) = lmk(51)
    (bundle["dynamic_lmk_faces_idx"],
     bundle["dynamic_lmk_bary_coords"]) = lmk(79, 17)
    bundle["full_lmk_faces_idx"], bundle["full_lmk_bary_coords"] = lmk(68)
    bundle["mp_lmk_faces_idx"], bundle["mp_lmk_bary_coords"] = lmk(105)
    bundle["mp_landmark_indices"] = np.sort(
        rng.choice(478, 105, replace=False)).astype(np.int32)

    # eyelid blendshapes: close the lids by ~3 mm around each eye
    for name, ex in (("l_eyelid", 0.03), ("r_eyelid", -0.03)):
        d2 = ((verts[:, 0] - ex) / 0.012) ** 2 + ((verts[:, 1] - 0.02) / 0.008) ** 2
        disp = np.zeros_like(verts)
        disp[:, 1] = -0.003 * np.exp(-d2) * (verts[:, 2] > 0)
        bundle[name] = disp.astype(np.float32)

    probs = np.zeros(len(faces), np.float32)
    probs[region_faces] = rng.choice(
        np.asarray([0.0, 0.5, 1.0], np.float32), size=len(region_faces))
    bundle["face_vertex_ids"] = face_vertex_ids.astype(np.int64)
    bundle["face_probabilities"] = probs
    bundle["is_synthetic_flame"] = True
    return bundle


def cam_fix(bundle: Dict) -> Dict:
    """The face region recentred onto the optical axis, in the template
    (smirk_tpu_torch/bench.py's cam_fix: seeded encoders leave cam near
    [7, 0, 0], and an off-centre head would render an empty scene)."""
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    return dict(bundle, v_template=vt)


def head(full_size: bool = True) -> Dict:
    """The benchmark's head: procedural_bundle(seed=0), recentred."""
    return cam_fix(procedural_bundle(seed=0, full_size=full_size))
