"""Mesh renderer: orthographic projection + face-region cut + fused raster
+ shading (port of smirk_tpu/render/renderer.py, inference path).

Images are NHWC in [0,1]; the coverage mask is returned explicitly.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from smirk_tpu_torch.assets import keep_vertices_and_update_faces
from smirk_tpu_torch.device import resolve_device
from smirk_tpu_torch.render import camera as camera_lib
from smirk_tpu_torch.render import geometry, shading
from smirk_tpu_torch.render import rasterizer as raster_lib

Z_OFFSET = 10.0  # keep min z above the rasterizer's near plane


def _env_set(name: str) -> Optional[str]:
    """The variable's value, or None when unset or empty."""
    value = os.environ.get(name)
    return value if value not in (None, "") else None


class Renderer(nn.Module):
    """Inference renderer over the FLAME face region.

    bin_capacity / raster_compact default to the JAX package's auto sizes
    (capacity 384 and a 216-chunk budget at 224 px on the 3408-face
    region). raster_compact=0, or env SMIRK_RASTER_COMPACT=0, selects the
    padded per-tile layout. Binning is an exact top-k, so no overlapping
    face is lost to selection and `raster_overflow` counts only chunks
    dropped past the compact budget.
    """

    def __init__(
        self,
        bundle: Dict[str, np.ndarray],
        render_full_head: bool = False,
        image_size: int = 224,
        bin_capacity: Optional[int] = None,
        raster_compact: Optional[int] = None,
        device: Optional[str] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.image_size = image_size

        faces = np.asarray(bundle["faces"], np.int64)
        if render_full_head:
            self.kept_vertices = np.arange(int(faces.max()) + 1)
            render_faces = faces.astype(np.int32)
        else:
            # cut the mesh to the FLAME 'face' region
            render_faces, self.kept_vertices = keep_vertices_and_update_faces(
                faces, np.asarray(bundle["face_vertex_ids"]))
        self.num_render_verts = len(self.kept_vertices)
        fidx, cidx = geometry.build_vertex_face_incidence(
            render_faces, self.num_render_verts)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.register_buffer("faces", i64(render_faces))
        self.register_buffer("kept", i64(self.kept_vertices))
        self.register_buffer("inc_face", i64(fidx))
        self.register_buffer("inc_corner", i64(cidx))

        F = len(render_faces)
        if bin_capacity is None:
            # ~4x the uniform faces-per-tile average, floor 384, capped at
            # the face count rounded up to a chunk
            tiles = max(1, -(-image_size // raster_lib.TILE_ROWS)
                        * -(-image_size // raster_lib.TILE_COLS))
            need = max(384, -(-4 * F // tiles // 32) * 32)
            bin_capacity = min(-(-F // 32) * 32, need)
        self.bin_capacity = bin_capacity

        env = _env_set("SMIRK_RASTER_COMPACT")
        if raster_compact is None and env is not None:
            raster_compact = int(env)  # 0 = padded per-tile layout
        if raster_compact is None:
            # compact chunk budget = 1.5 face-chunks per face + one rounding
            # chunk per tile, clamped to [96, worst case]
            CH = raster_lib.V3_CHUNK
            ty = -(-image_size // raster_lib.TILE_ROWS)
            tx = -(-image_size // raster_lib.TILE_COLS)
            Tp = -(-(ty * tx) // 8) * 8
            worst = Tp * (self.bin_capacity // CH)
            est = -(-(F * 3) // (2 * CH)) + Tp
            raster_compact = min(worst, max(96, -(-est // 8) * 8))
        self.raster_compact = raster_compact

    def _face_geometry(self, vertices, transformed_vertices):
        """-> face_verts (NDC, z + Z_OFFSET) and corner normals, (B,F,3,3)."""
        sub_v = vertices[:, self.kept]
        sub_tv = transformed_vertices[:, self.kept]
        sub_tv = torch.cat([sub_tv[..., :2], sub_tv[..., 2:] + Z_OFFSET], dim=-1)
        normals = geometry.vertex_normals_gather(
            sub_v, self.faces, self.inc_face, self.inc_corner)
        face_normals = geometry.face_vertices(normals, self.faces)
        face_verts = geometry.face_vertices(sub_tv, self.faces)
        return face_verts, face_normals

    @torch.no_grad()
    def measure_compact_occupancy(self, vertices, cam) -> dict:
        """Measured occupied-chunk count (max over images) vs the compact
        budget for a scene, and headroom = budget / occupancy."""
        tv = self.project(vertices, cam)
        face_verts, _ = self._face_geometry(vertices, tv)
        _, counts = raster_lib.bin_faces_flat(
            face_verts, self.image_size, self.bin_capacity)
        CH = raster_lib.V3_CHUNK
        occupied = int(((counts + CH - 1) // CH).sum(dim=1).max())
        budget = int(self.raster_compact) if self.raster_compact else 0
        return {
            "occupied_chunks": occupied,
            "budget": budget,
            "headroom": (budget / occupied) if occupied else float("inf"),
        }

    def project(self, vertices: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """Full-mesh NDC vertices (y/z flipped)."""
        return camera_lib.orth_proj_ndc(vertices, cam)

    def forward(
        self,
        vertices: torch.Tensor,  # (B,V,3) FLAME world-space vertices
        cam: torch.Tensor,  # (B,3) [scale, tx, ty]
        landmarks: Optional[Dict[str, torch.Tensor]] = None,
        inference: bool = False,
    ) -> Dict[str, torch.Tensor]:
        if not inference:
            raise NotImplementedError(
                "the differentiable render (Renderer.render) belongs to the "
                "training slice of the port, which is not written yet; pass "
                "inference=True for the fused inference render")
        out = {}
        transformed_vertices = self.project(vertices, cam)
        out["transformed_vertices"] = transformed_vertices
        if landmarks:
            for key, lmk in landmarks.items():
                out[key] = camera_lib.project_landmarks(lmk, cam)
        rendered, mask, pix_to_face, overflow = self.render_inference(
            vertices, transformed_vertices)
        out["rendered_img"] = rendered
        out["rendered_mask"] = mask
        out["pix_to_face"] = pix_to_face
        # (B,) int32 compact chunks dropped past the budget: 0 = exact
        # render; > 0 = trailing tiles rendered EMPTY
        out["raster_overflow"] = overflow
        return out

    @torch.no_grad()
    def render_inference(self, vertices, transformed_vertices):
        """Gather-free inference render via the fused raster (coverage +
        normal-plane evaluation in one pass) -> (shaded image (B,H,W,3),
        mask (B,H,W,1), pix_to_face (B,H,W), overflow (B,))."""
        face_verts, face_normals = self._face_geometry(vertices, transformed_vertices)
        normal_img, pix_to_face, _, overflow = raster_lib.rasterize_normals_fused(
            face_verts, face_normals, self.image_size,
            capacity=self.bin_capacity,
            compact=self.raster_compact or None,
            return_overflow=True,
        )
        mask = (pix_to_face >= 0)[..., None].to(normal_img.dtype)
        shade = shading.directional_shading(normal_img)
        return shading.GRAY_ALBEDO * shade * mask, mask, pix_to_face, overflow
