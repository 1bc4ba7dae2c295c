"""The reference's renderer: orthographic projection, the FLAME face
region, a dense z-buffer over every (pixel, face) pair and directional
shading.

The program bins faces into tiles and walks them in CUDA kernels; this
tests every face at every pixel centre in plain PyTorch, in blocks of
rows. Its conventions are the program's published ones (NDC pixel centre
(2i + 1 - S) / S, +y down; edge functions sign-normalized so that inside
is e >= 0 for either winding; smaller z is nearer; on equal depth the
lower face id wins; faces with |2 area| < 1e-10 are never inside). The
value at a covered pixel is the winning face's attribute plane, evaluated
at the pixel centre: `attr_planes` for the differentiable render (whose
gradient reaches the vertices through the planes, by autograd through a
per-pixel gather), `normal_planes` for the inference render. Coverage
carries no gradient.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import camera, geometry, shading

Z_OFFSET = 10.0
AREA_EPS = 1e-10
BIG_Z = 1e10
# elements of one (rows, W, F) block of the z-buffer
BLOCK_ELEMS = 1 << 25


def pixel_centres(size: int, device) -> torch.Tensor:
    num = 2.0 * torch.arange(size, device=device, dtype=torch.float32) + 1.0 - size
    return num / torch.full_like(num, float(size))


def edge_planes(fv: torch.Tensor):
    """(B,F,3,3) NDC faces -> (edges (B,F,9) [a0 b0 c0 a1 b1 c1 a2 b2 c2]
    sign-normalized, depth plane (B,F,3) [zA zB zC], valid (B,F))."""
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - y1 * x2
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - y2 * x0
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - y0 * x1
    denom = a0 * x0 + b0 * y0 + c0
    valid = denom.abs() >= AREA_EPS
    s = torch.where(denom >= 0, 1.0, -1.0)
    inv = 1.0 / torch.where(valid, denom.abs(), 1.0)
    e = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], -1) * s[..., None]
    z = (e[..., 0:3] * z0[..., None] + e[..., 3:6] * z1[..., None]
         + e[..., 6:9] * z2[..., None]) * inv[..., None]
    return e, z, valid


@torch.no_grad()
def zbuffer(fv: torch.Tensor, size: int) -> torch.Tensor:
    """(B,F,3,3) -> pix_to_face (B,S,S) int64, -1 where no face covers."""
    B, F = fv.shape[:2]
    dev = fv.device
    e, z, valid = edge_planes(fv.detach())
    c = pixel_centres(size, dev)
    xs = c[None, :, None]  # (1,W,1)
    rows = max(1, BLOCK_ELEMS // (size * F))
    ids = torch.arange(F, device=dev)
    out = torch.empty((B, size, size), dtype=torch.long, device=dev)
    for b in range(B):
        eb, zb, vb = e[b], z[b], valid[b]

        def aff(p, i, ys):
            return p[:, i] * xs + p[:, i + 1] * ys + p[:, i + 2]

        for r0 in range(0, size, rows):
            ys = c[r0:r0 + rows][:, None, None]  # (r,1,1)
            inside = (aff(eb, 0, ys) >= 0) & (aff(eb, 3, ys) >= 0) & (aff(eb, 6, ys) >= 0) & vb
            depth = torch.where(inside, aff(zb, 0, ys), BIG_Z)  # (r,W,F)
            near = depth.amin(-1, keepdim=True)
            first = torch.where(depth == near, ids, F).amin(-1)
            out[b, r0:r0 + rows] = torch.where(near[..., 0] < BIG_Z, first, -1)
    return out


def attr_planes(fv: torch.Tensor, attributes: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of corner attributes as affine planes:
    (B,F,3,3), (B,F,3,D) -> (B,F,3D) [PA | PB | PC], value PA x + PB y + PC."""
    x0, y0 = fv[..., 0, 0], fv[..., 0, 1]
    x1, y1 = fv[..., 1, 0], fv[..., 1, 1]
    x2, y2 = fv[..., 2, 0], fv[..., 2, 1]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - y1 * x2
    denom = a0 * x0 + b0 * y0 + c0
    inv = 1.0 / torch.where(denom.abs() >= AREA_EPS, denom, 1.0)
    k = torch.stack([y1 - y2, x2 - x1, x1 * y2 - y1 * x2,
                     y2 - y0, x0 - x2, x2 * y0 - y2 * x0,
                     y0 - y1, x1 - x0, x0 * y1 - y0 * x1], -1) * inv[..., None]
    n0, n1, n2 = attributes[..., 0, :], attributes[..., 1, :], attributes[..., 2, :]
    PA = k[..., 0:1] * n0 + k[..., 3:4] * n1 + k[..., 6:7] * n2
    PB = k[..., 1:2] * n0 + k[..., 4:5] * n1 + k[..., 7:8] * n2
    PC = k[..., 2:3] * n0 + k[..., 5:6] * n1 + k[..., 8:9] * n2
    return torch.cat([PA, PB, PC], -1)


def normal_planes(fv: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """The same planes written about corner 0 (the inference render's
    form): slopes from the edges and attribute steps out of corner 0."""
    x0, y0 = fv[..., 0, 0], fv[..., 0, 1]
    dx1, dy1 = fv[..., 1, 0] - x0, fv[..., 1, 1] - y0
    dx2, dy2 = fv[..., 2, 0] - x0, fv[..., 2, 1] - y0
    denom = dx1 * dy2 - dy1 * dx2
    inv = (1.0 / torch.where(denom.abs() >= AREA_EPS, denom, 1.0))[..., None]
    n0 = normals[..., 0, :]
    d1, d2 = normals[..., 1, :] - n0, normals[..., 2, :] - n0
    PA = (d1 * dy2[..., None] - d2 * dy1[..., None]) * inv
    PB = (d2 * dx1[..., None] - d1 * dx2[..., None]) * inv
    PC = n0 - PA * x0[..., None] - PB * y0[..., None]
    return torch.cat([PA, PB, PC], -1)


def planes_at_pixels(planes: torch.Tensor, p2f: torch.Tensor, size: int) -> torch.Tensor:
    """The winner's planes (B,F,3D) evaluated at each covered pixel centre
    -> (B,S,S,D), 0 where uncovered (differentiable in planes)."""
    B = planes.shape[0]
    D = planes.shape[-1] // 3
    c = pixel_centres(size, planes.device)
    xs, ys = c[None, None, :, None], c[None, :, None, None]
    b = torch.arange(B, device=planes.device)[:, None, None]
    p = planes[b, p2f.clamp_min(0)]  # (B,S,S,3D)
    vals = p[..., :D] * xs + p[..., D:2 * D] * ys + p[..., 2 * D:]
    return torch.where((p2f >= 0)[..., None], vals, 0.0)


def keep_vertices_and_update_faces(faces: np.ndarray, keep: np.ndarray):
    """The mesh cut to a vertex subset -> (renumbered faces, kept ids)."""
    keep = np.unique(np.asarray(keep, np.int64))
    remap = np.full(int(faces.max()) + 1, -1, np.int64)
    remap[keep] = np.arange(len(keep))
    mapped = remap[faces]
    return mapped[(mapped != -1).all(axis=1)], keep


class Renderer(torch.nn.Module):
    """The FLAME face region, projected, z-buffered and shaded."""

    def __init__(self, bundle: Dict[str, np.ndarray], image_size: int, device):
        super().__init__()
        self.image_size = image_size
        faces, kept = keep_vertices_and_update_faces(
            np.asarray(bundle["faces"], np.int64), np.asarray(bundle["face_vertex_ids"]))
        fidx, cidx = geometry.build_vertex_face_incidence(faces, len(kept))

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.faces, self.kept = i64(faces), i64(kept)
        self.inc_face, self.inc_corner = i64(fidx), i64(cidx)

    def face_geometry(self, vertices, transformed):
        """-> face vertices in NDC with z + Z_OFFSET, corner normals, (B,F,3,3)."""
        sub_tv = transformed[:, self.kept]
        sub_tv = torch.cat([sub_tv[..., :2], sub_tv[..., 2:] + Z_OFFSET], -1)
        normals = geometry.vertex_normals_gather(vertices[:, self.kept], self.faces,
                                                 self.inc_face, self.inc_corner)
        return (geometry.face_vertices(sub_tv, self.faces),
                geometry.face_vertices(normals, self.faces))

    def forward(self, vertices, cam, landmarks: Optional[Dict[str, torch.Tensor]] = None,
                inference: bool = False) -> Dict[str, torch.Tensor]:
        out = {"transformed_vertices": camera.orth_proj_ndc(vertices, cam)}
        for key, lmk in (landmarks or {}).items():
            out[key] = camera.project_landmarks(lmk, cam)
        fv, fn = self.face_geometry(vertices, out["transformed_vertices"])
        S = self.image_size
        p2f = zbuffer(fv, S)
        if inference:
            with torch.no_grad():
                normal_img = planes_at_pixels(normal_planes(fv, fn), p2f, S)
        else:
            normal_img = planes_at_pixels(attr_planes(fv, fn), p2f, S)
        mask = (p2f >= 0)[..., None].to(normal_img.dtype)
        shade = shading.directional_shading(normal_img)
        out["rendered_img"] = shading.GRAY_ALBEDO * shade * mask
        out["rendered_mask"] = mask
        out["pix_to_face"] = p2f
        out["face_verts"] = fv.detach()
        return out
