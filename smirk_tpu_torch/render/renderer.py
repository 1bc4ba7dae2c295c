"""Mesh renderer: orthographic projection + face-region cut + raster +
shading (port of smirk_tpu/render/renderer.py).

`forward(inference=True)` takes the fused, non-differentiable inference
raster (`render_inference`); `forward(inference=False)` the differentiable
planes raster (`render`), whose gradient reaches the vertices through the
interpolated normals and the barycentrics. Images are NHWC in [0,1]; the
coverage mask is returned explicitly.
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
    """Renderer over the FLAME face region.

    bin_capacity / raster_compact default to the JAX package's auto sizes
    (capacity 384 and a 216-chunk budget at 224 px on the 3408-face
    region). raster_compact=0, or env SMIRK_RASTER_COMPACT=0, selects the
    padded per-tile layout.

    bin_approx / diff_bin_approx: the recall target of the approximate
    binning of the inference / differentiable raster (the JAX package's
    defaults, 0.95; None = exact). The port's selector is exact either
    way (`rasterizer.approx_max_k`). A non-empty SMIRK_DIFF_BIN_EXACT
    clears diff_bin_approx. bin_miss_check: None arms each path's
    selection-miss check where its approx binning is on
    (`bin_miss_check_fused`, `bin_miss_check_diff`); True / False arms /
    disarms both, as SMIRK_BIN_MISS_CHECK does when the argument is None
    ("0" disarms, any other non-empty value arms, empty is unset). An
    armed path adds its misses to `raster_overflow`.

    The arguments after bin_capacity are keyword-only: the JAX package's
    fifth is use_pallas, which the port does not take (the device picks
    each kernel or its plain version).
    """

    def __init__(
        self,
        bundle: Dict[str, np.ndarray],
        render_full_head: bool = False,
        image_size: int = 224,
        bin_capacity: Optional[int] = None,
        *,
        bin_approx: Optional[float] = 0.95,
        diff_bin_approx: Optional[float] = 0.95,
        bin_miss_check: Optional[bool] = None,
        raster_compact: Optional[int] = None,
        device: Optional[str] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.image_size = image_size
        self.bin_approx = bin_approx
        self.diff_bin_approx = diff_bin_approx
        if _env_set("SMIRK_DIFF_BIN_EXACT") is not None:
            self.diff_bin_approx = None
        env = _env_set("SMIRK_BIN_MISS_CHECK")
        if bin_miss_check is None and env is not None:
            bin_miss_check = env != "0"
        if bin_miss_check is None:
            self.bin_miss_check_diff = self.diff_bin_approx is not None
            self.bin_miss_check_fused = self.bin_approx is not None
        else:
            self.bin_miss_check_diff = bool(bin_miss_check)
            self.bin_miss_check_fused = bool(bin_miss_check)

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
        # the shading's unit light directions, on the device (as a host
        # array they would be copied in, with a sync, at every render)
        self.register_buffer("light_directions", torch.as_tensor(
            shading.unit_directions(), dtype=torch.float32, device=device), persistent=False)

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
        _, counts = raster_lib.bin_faces(
            face_verts, self.image_size, self.bin_capacity)
        CH = raster_lib.V3_CHUNK
        occupied = int(((counts + CH - 1) // CH).sum(dim=1).max())
        budget = int(self.raster_compact) if self.raster_compact else 0
        return {
            "occupied_chunks": occupied,
            "budget": budget,
            "headroom": (budget / occupied) if occupied else float("inf"),
        }

    def inference_settings(self) -> tuple:
        """What `render_inference` reads besides tensors: its sizes and
        switches, and the rasterizer's process-wide modes. A captured call
        (`SmirkSystem.infer`'s CUDA graphs) holds those it was captured
        under."""
        return (self.image_size, self.bin_capacity, self.raster_compact, self.bin_approx,
                self.bin_miss_check_fused, raster_lib.modes())

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
        out = {}
        transformed_vertices = self.project(vertices, cam)
        out["transformed_vertices"] = transformed_vertices
        if landmarks:
            for key, lmk in landmarks.items():
                out[key] = camera_lib.project_landmarks(lmk, cam)
        render_fn = self.render_inference if inference else self.render
        rendered, mask, pix_to_face, overflow = render_fn(
            vertices, transformed_vertices)
        out["rendered_img"] = rendered
        out["rendered_mask"] = mask
        out["pix_to_face"] = pix_to_face
        # (B,) int32 compact chunks dropped past the budget, plus the
        # binning's selection misses where the path's check is armed: 0 =
        # exact render; > 0 = trailing tiles rendered EMPTY or faces missed
        # (and, in training, no gradient there)
        out["raster_overflow"] = overflow
        return out

    def render(self, vertices, transformed_vertices):
        """Differentiable render -> (shaded image (B,H,W,3), mask
        (B,H,W,1), pix_to_face (B,H,W), overflow (B,)): the vertex normals
        are D=3 interpolated attributes of the planes raster, shaded by 5
        directional lights on gray albedo."""
        face_verts, face_normals = self._face_geometry(vertices, transformed_vertices)
        normal_img, mask, pix_to_face, overflow = raster_lib.rasterize(
            face_verts, face_normals, self.image_size,
            capacity=self.bin_capacity,
            compact=self.raster_compact or None,
            bin_approx=self.diff_bin_approx,
            bin_miss_check=self.bin_miss_check_diff,
        )
        shade = shading.directional_shading(normal_img, self.light_directions)
        return shading.GRAY_ALBEDO * shade * mask, mask, pix_to_face, overflow

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
            bin_approx=self.bin_approx,
            return_overflow=True,
            bin_miss_check=self.bin_miss_check_fused,
        )
        mask = (pix_to_face >= 0)[..., None].to(normal_img.dtype)
        shade = shading.directional_shading(normal_img, self.light_directions)
        return shading.GRAY_ALBEDO * shade * mask, mask, pix_to_face, overflow
