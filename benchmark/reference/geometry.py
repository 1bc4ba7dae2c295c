"""Frozen copy of smirk_tpu_torch/render/geometry.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

Mesh geometry helpers: per-face vertex gather, area-weighted vertex
normals (port of smirk_tpu/render/geometry.py)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """vertices (B,V,3), faces (F,3) or (B,F,3) int -> (B,F,3,3)."""
    if faces.ndim == 2:
        return vertices[:, faces]
    b = torch.arange(vertices.shape[0], device=vertices.device)[:, None, None]
    return vertices[b, faces]


def _corner_normals(fv: torch.Tensor) -> torch.Tensor:
    """Unnormalized face normal at each corner, corner order n0, n1, n2
    (each from its own edge pair, as the reference accumulates them)."""
    n1 = torch.linalg.cross(fv[:, :, 2] - fv[:, :, 1], fv[:, :, 0] - fv[:, :, 1])
    n2 = torch.linalg.cross(fv[:, :, 0] - fv[:, :, 2], fv[:, :, 1] - fv[:, :, 2])
    n0 = torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0])
    return torch.stack([n0, n1, n2], dim=2)  # (B,F,3,3)


def _normalize(normals: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    return normals / norm.clamp_min(1e-6)


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, normalized with eps 1e-6. (B,V,3).
    faces (F,3) shared topology; accumulated with index_add_."""
    B, V = vertices.shape[:2]
    contribs = _corner_normals(face_vertices(vertices, faces))
    out = torch.zeros((B, V, 3), dtype=vertices.dtype, device=vertices.device)
    out.index_add_(1, faces.reshape(-1).long(), contribs.reshape(B, -1, 3))
    return _normalize(out)


def build_vertex_face_incidence(
    faces: np.ndarray, num_verts: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Static incidence tables: for each vertex, the faces touching it and
    the corner index it occupies. -> (face_idx (V,D), corner_idx (V,D)),
    -1 padded, D = max vertex degree. Makes vertex normals a gather."""
    faces = np.asarray(faces)
    lists: list = [[] for _ in range(num_verts)]
    for fi, tri in enumerate(faces):
        for ci, v in enumerate(tri):
            lists[v].append((fi, ci))
    D = max(1, max(len(l) for l in lists))
    fidx = np.full((num_verts, D), -1, np.int32)
    cidx = np.zeros((num_verts, D), np.int32)
    for v, l in enumerate(lists):
        for j, (fi, ci) in enumerate(l):
            fidx[v, j] = fi
            cidx[v, j] = ci
    return fidx, cidx


def vertex_normals_gather(
    vertices: torch.Tensor,  # (B,V,3)
    faces: torch.Tensor,  # (F,3) shared topology
    incidence_face: torch.Tensor,  # (V,D) int, -1 pad
    incidence_corner: torch.Tensor,  # (V,D) int
) -> torch.Tensor:
    """Scatter-free vertex normals; equal to `vertex_normals` up to fp
    summation order."""
    contribs = _corner_normals(face_vertices(vertices, faces))  # (B,F,3,3)
    valid = (incidence_face >= 0)[None, :, :, None]
    f = incidence_face.clamp_min(0).long()
    gathered = contribs[:, f, incidence_corner.long()]  # (B,V,D,3)
    normals = torch.where(valid, gathered, 0.0).sum(dim=2)
    return _normalize(normals)
