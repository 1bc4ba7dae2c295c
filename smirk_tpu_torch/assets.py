"""Asset loading: FLAME model data -> plain numpy dicts (a "bundle").

A copy of the loaders in `smirk_tpu/assets.py` (the port imports nothing
of the JAX package), plus `procedural_bundle`, a deterministic head-like
mesh at FLAME's sizes that stands in for the FLAME assets when they are
absent. Both packages take the same bundle dict, so tests build one bundle
and hand it to the JAX classes and to the port alike.

The FLAME2020 `generic_model.pkl` is license-gated. When it is absent the
deformation tensors come from `synthetic_deformation_tensors`.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

N_SHAPE_FULL = 300
N_EXP_FULL = 100
NUM_JOINTS = 5

# FLAME region -> sampling probability for mesh-anchored pixel hints
# (reference src/utils/masking.py:18-31).
AREA_WEIGHTS = {
    "neck": 0.0,
    "right_eyeball": 0.0,
    "right_ear": 0.0,
    "lips": 0.5,
    "nose": 0.5,
    "left_ear": 0.0,
    "eye_region": 1.0,
    "forehead": 1.0,
    "left_eye_region": 1.0,
    "right_eye_region": 1.0,
    "face_clean": 1.0,
    "cleaner_lips": 1.0,
}


def _to_np(a, dtype=np.float32):
    if "scipy.sparse" in str(type(a)):
        a = a.todense()
    if "Tensor" in type(a).__name__:  # torch tensor inside landmark npy
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def load_obj(path: str):
    """Minimal wavefront OBJ parser (vertices, uvs, faces, uv faces).

    Only handles v/vt/f records with 1-based `v/vt` indices, which is all
    the FLAME head template uses.
    """
    verts, uvs, faces, uvfaces = [], [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = [t.split("/") for t in line.split()[1:4]]
                faces.append([int(t[0]) - 1 for t in idx])
                if len(idx[0]) > 1 and idx[0][1]:
                    uvfaces.append([int(t[1]) - 1 for t in idx])
    return (
        np.asarray(verts, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvfaces, np.int32) if uvfaces else None,
    )


def load_flame_pkl(path: str) -> Dict[str, np.ndarray]:
    """Convert the FLAME2020 generic_model.pkl into plain numpy arrays:
    posedirs reshaped to (P, V*3), kintree row 0 as parents with
    parents[0] = -1, the full 400-component shapedirs."""
    with open(path, "rb") as f:
        ss = pickle.load(f, encoding="latin1")
    posedirs = _to_np(ss["posedirs"])  # (V,3,P)
    num_pose_basis = posedirs.shape[-1]
    parents = _to_np(ss["kintree_table"], np.int64)[0]
    parents[0] = -1
    return {
        "v_template": _to_np(ss["v_template"]),
        "shapedirs": _to_np(ss["shapedirs"]),  # (V,3,400)
        "posedirs": posedirs.reshape(-1, num_pose_basis).T.copy(),  # (P,V*3)
        "J_regressor": _to_np(ss["J_regressor"]),  # (J,V)
        "parents": parents,
        "lbs_weights": _to_np(ss["weights"]),  # (V,J)
        "faces": _to_np(ss["f"], np.int32),  # (F,3)
    }


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


def load_landmark_embeddings(asset_root: str) -> Dict[str, np.ndarray]:
    """FAN-68 static/dynamic + mediapipe-105 landmark embeddings. The
    dynamic contour LUT rows are stored as torch tensors inside the npy."""
    lmk = np.load(
        os.path.join(asset_root, "landmark_embedding.npy"),
        allow_pickle=True,
        encoding="latin1",
    )[()]
    mp = np.load(
        os.path.join(
            asset_root,
            "mediapipe_landmark_embedding/mediapipe_landmark_embedding.npz",
        )
    )
    return {
        "static_lmk_faces_idx": _to_np(lmk["static_lmk_faces_idx"], np.int32),
        "static_lmk_bary_coords": _to_np(lmk["static_lmk_bary_coords"]),
        "dynamic_lmk_faces_idx": _to_np(lmk["dynamic_lmk_faces_idx"], np.int32),
        "dynamic_lmk_bary_coords": _to_np(lmk["dynamic_lmk_bary_coords"]),
        "full_lmk_faces_idx": _to_np(lmk["full_lmk_faces_idx"], np.int32)[0],
        "full_lmk_bary_coords": _to_np(lmk["full_lmk_bary_coords"])[0],
        "mp_lmk_faces_idx": _to_np(mp["lmk_face_idx"], np.int32),
        "mp_lmk_bary_coords": _to_np(mp["lmk_b_coords"]),
        "mp_landmark_indices": _to_np(mp["landmark_indices"], np.int32),
    }


def load_eyelids(asset_root: str) -> Dict[str, np.ndarray]:
    """Left/right eyelid-close blendshapes (V,3)."""
    return {
        "l_eyelid": _to_np(np.load(os.path.join(asset_root, "l_eyelid.npy"))),
        "r_eyelid": _to_np(np.load(os.path.join(asset_root, "r_eyelid.npy"))),
    }


def load_flame_masks(asset_root: str) -> Dict[str, np.ndarray]:
    """Vertex-region masks (FLAME_masks.pkl)."""
    with open(os.path.join(asset_root, "FLAME_masks/FLAME_masks.pkl"), "rb") as f:
        masks = pickle.load(f, encoding="latin1")
    return {k: _to_np(v, np.int64) for k, v in masks.items()}


def load_face_probabilities(asset_root: str, num_faces: int = 9976) -> np.ndarray:
    """Per-triangle sampling probability table."""
    tri = np.load(
        os.path.join(asset_root, "FLAME_masks/FLAME_masks_triangles.npy"),
        allow_pickle=True,
    ).item()
    probs = np.zeros(num_faces, np.float32)
    for area, w in AREA_WEIGHTS.items():
        probs[np.asarray(tri[area], np.int64)] = w
    return probs


def keep_vertices_and_update_faces(faces: np.ndarray, keep: np.ndarray):
    """Cut the mesh to a vertex subset, renumbering faces.

    Returns (new_faces, kept_vertex_indices); downstream code gathers
    vertices with `verts[:, kept]`.
    """
    keep = np.unique(np.asarray(keep, np.int64))
    max_v = int(faces.max()) + 1
    remap = np.full(max_v, -1, np.int64)
    remap[keep] = np.arange(len(keep))
    mapped = remap[faces]
    valid = (mapped != -1).all(axis=1)
    return mapped[valid].astype(np.int32), keep


def default_asset_root() -> Optional[str]:
    """$SMIRK_ASSETS, else the repository's `assets/` directory."""
    for cand in (
        os.environ.get("SMIRK_ASSETS"),
        os.path.join(os.path.dirname(__file__), "..", "assets"),
    ):
        if cand and os.path.isdir(cand):
            return os.path.abspath(cand)
    return None


def load_all(asset_root: Optional[str] = None, *, synthetic_seed: int = 0):
    """One-stop asset bundle for FlameModel / Renderer.

    Falls back to synthetic deformation tensors when generic_model.pkl is
    absent (its presence requires accepting the FLAME license).
    """
    asset_root = asset_root or default_asset_root()
    if asset_root is None:
        raise FileNotFoundError("no asset root found; set SMIRK_ASSETS")

    verts, uvs, faces_obj, uvfaces = load_obj(
        os.path.join(asset_root, "head_template.obj")
    )
    pkl_path = os.path.join(asset_root, "FLAME2020", "generic_model.pkl")
    if os.path.isfile(pkl_path):
        flame = load_flame_pkl(pkl_path)
    else:
        flame = synthetic_deformation_tensors(
            len(verts), faces_obj, verts, seed=synthetic_seed
        )

    bundle = dict(flame)
    bundle.update(load_landmark_embeddings(asset_root))
    bundle.update(load_eyelids(asset_root))
    bundle["uvcoords"] = uvs
    bundle["uvfaces"] = uvfaces
    bundle["face_vertex_ids"] = load_flame_masks(asset_root)["face"]
    bundle["face_probabilities"] = load_face_probabilities(
        asset_root, bundle["faces"].shape[0]
    )
    bundle["is_synthetic_flame"] = not os.path.isfile(pkl_path)
    return bundle


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
    Deformation tensors come from `synthetic_deformation_tensors`; the
    landmark embeddings, eyelid blendshapes and per-face sampling
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
