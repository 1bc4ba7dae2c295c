"""Frozen copy of smirk_tpu_torch/flame/model.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

FLAME parametric head model (port of smirk_tpu/flame/model.py;
reference src/FLAME/FLAME.py:232-315): params dict -> vertices + FAN-68 /
full-68 / mediapipe-105 landmarks."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference import lbs as lbs_lib

N_SHAPE_FULL = 300  # FLAME's shape components before the expression ones


class FlameModel(nn.Module):
    """Holds FLAME constants as buffers; `forward` maps parameter dicts to
    geometry.

    Parameter keys (reference FLAME.forward, FLAME.py:232-248):
      shape_params (B,<=n_shape), expression_params (B,<=n_exp),
      pose_params (B,3), jaw_params (B,3), optional eyelid_params (B,2),
      optional eye_pose_params (B,6), neck_pose_params (B,3).
    """

    def __init__(self, bundle: Dict[str, np.ndarray], n_shape: int = 300,
                 n_exp: int = 50, device: Optional[str] = None):
        super().__init__()
        self.n_shape = n_shape
        self.n_exp = n_exp

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        sd = bundle["shapedirs"]
        # slice [0:n_shape] shape PCs + [300:300+n_exp] expression PCs
        # (reference FLAME.py:67-68)
        self.register_buffer("shapedirs", f32(np.concatenate(
            [sd[:, :, :n_shape],
             sd[:, :, N_SHAPE_FULL:N_SHAPE_FULL + n_exp]],
            axis=2)))
        for name in ("v_template", "posedirs", "J_regressor", "lbs_weights",
                     "l_eyelid", "r_eyelid", "dynamic_lmk_bary_coords"):
            self.register_buffer(name, f32(bundle[name]))
        self.register_buffer("faces", i64(bundle["faces"]))
        self.register_buffer("lmk_faces_idx", i64(bundle["static_lmk_faces_idx"]))
        self.register_buffer("lmk_bary_coords", f32(bundle["static_lmk_bary_coords"]))
        self.register_buffer("dynamic_lmk_faces_idx", i64(bundle["dynamic_lmk_faces_idx"]))
        self.register_buffer("full_lmk_faces_idx", i64(bundle["full_lmk_faces_idx"]))
        self.register_buffer("full_lmk_bary_coords", f32(bundle["full_lmk_bary_coords"]))
        self.register_buffer("mp_lmk_faces_idx", i64(bundle["mp_lmk_faces_idx"]))
        self.register_buffer("mp_lmk_bary_coords", f32(bundle["mp_lmk_bary_coords"]))
        self.parents = np.asarray(bundle["parents"], np.int64)  # static

        # neck kinematic chain: walk parents from NECK_IDX=1 to root
        # (reference FLAME.py:103-108)
        chain, cur = [], 1
        while cur != -1:
            chain.append(cur)
            cur = int(self.parents[cur])
        self.neck_kin_chain = np.asarray(chain, np.int64)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @staticmethod
    def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
        if x.shape[1] < n:
            x = torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1]))], dim=1)
        return x

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        *,
        zero_expression: bool = False,
        zero_shape: bool = False,
        zero_pose: bool = False,
    ) -> Dict[str, torch.Tensor]:
        shape = self._pad(params["shape_params"], self.n_shape)
        expr = self._pad(params["expression_params"], self.n_exp)
        B = shape.shape[0]
        pose = params.get("pose_params")
        jaw = params.get("jaw_params")
        eye = params.get("eye_pose_params")
        neck = params.get("neck_pose_params")
        eyelid = params.get("eyelid_params")

        if zero_expression:  # reference FLAME.py:251-253
            expr = torch.zeros_like(expr)
            jaw = torch.zeros_like(jaw)
        if zero_shape:
            shape = torch.zeros_like(shape)
        if zero_pose:  # canonical viz pose (reference FLAME.py:259-262)
            pose = torch.zeros_like(pose)
            pose[..., 0] = 0.2
            pose[..., 1] = -0.7
        if eye is None:
            eye = shape.new_zeros((B, 6))
        if neck is None:
            neck = shape.new_zeros((B, 3))

        betas = torch.cat([shape, expr], dim=1)
        full_pose = torch.cat([pose, neck, jaw, eye], dim=1)

        vertices, _ = lbs_lib.lbs(
            betas, full_pose, self.v_template, self.shapedirs, self.posedirs,
            self.J_regressor, self.parents, self.lbs_weights,
        )

        if eyelid is not None:  # reference FLAME.py:284-286
            vertices = vertices + self.r_eyelid[None] * eyelid[:, 1:2, None]
            vertices = vertices + self.l_eyelid[None] * eyelid[:, 0:1, None]

        dyn_faces, dyn_bary = lbs_lib.find_dynamic_lmk_idx_and_bcoords(
            full_pose, self.dynamic_lmk_faces_idx,
            self.dynamic_lmk_bary_coords, self.neck_kin_chain,
        )
        n_static = self.lmk_faces_idx.shape[0]
        fan_faces = torch.cat(
            [dyn_faces, self.lmk_faces_idx[None].expand(B, n_static)], dim=1)
        fan_bary = torch.cat(
            [dyn_bary, self.lmk_bary_coords[None].expand(B, n_static, 3)], dim=1)

        landmarks_fan = lbs_lib.vertices2landmarks(
            vertices, self.faces, fan_faces, fan_bary)
        landmarks_fan_3d = lbs_lib.vertices2landmarks(
            vertices, self.faces, self.full_lmk_faces_idx,
            self.full_lmk_bary_coords)
        landmarks_mp = lbs_lib.vertices2landmarks(
            vertices, self.faces, self.mp_lmk_faces_idx, self.mp_lmk_bary_coords)

        return {
            "vertices": vertices,
            "landmarks_fan": landmarks_fan,
            "landmarks_fan_3d": landmarks_fan_3d,
            "landmarks_mp": landmarks_mp,
        }
