"""Linear-blend-skinning math for the FLAME head model (port of
smirk_tpu/flame/lbs.py; reference src/FLAME/lbs.py:101-377).

The 5-joint kinematic chain is walked in a Python loop over a static
parents table; blendshape contractions are einsums. Joints are picked by
Python int selects, not gathers by a host index array: such an array is
copied to the device, with a sync, at every call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rot_mat_to_euler_y(rot_mats: torch.Tensor) -> torch.Tensor:
    """Y-axis euler angle from rotation matrices (N,3,3) -> (N,)."""
    sy = torch.sqrt(rot_mats[:, 0, 0] ** 2 + rot_mats[:, 1, 0] ** 2)
    return torch.atan2(-rot_mats[:, 2, 0], sy)


def batch_rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle (N,3) -> rotation matrices (N,3,3). The +1e-8 is added
    inside the norm (not a clamp), as the reference does."""
    angle = torch.linalg.norm(rot_vecs + epsilon, dim=1, keepdim=True)  # (N,1)
    rot_dir = rot_vecs / angle

    cos = torch.cos(angle)[:, None]  # (N,1,1)
    sin = torch.sin(angle)[:, None]

    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1
    ).reshape(-1, 3, 3)

    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1.0 - cos) * torch.matmul(K, K)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """betas (B,L) x shape_disps (V,3,L) -> (B,V,3)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J,V) x (B,V,3) -> (B,J,3)."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N,3,3) rotations + (N,3,1) translations -> (N,4,4) rigid transforms,
    the bottom row [0 0 0 1] padded on."""
    return torch.cat([F.pad(R, (0, 0, 0, 1)), F.pad(t, (0, 0, 0, 1), value=1.0)], dim=2)


def batch_rigid_transform(
    rot_mats: torch.Tensor,  # (B,J,3,3)
    joints: torch.Tensor,  # (B,J,3)
    parents: np.ndarray,  # (J,) static host array, parents[0] == -1
):
    """Forward kinematics over a static joint tree. Returns posed joints
    (B,J,3) and per-joint relative transforms (B,J,4,4)."""
    B, J = joints.shape[:2]
    parents = np.asarray(parents)

    rel_joints = torch.stack(
        [joints[:, 0]] + [joints[:, i] - joints[:, int(parents[i])] for i in range(1, J)],
        dim=1)

    transforms_mat = transform_mat(
        rot_mats.reshape(-1, 3, 3), rel_joints.reshape(-1, 3, 1)
    ).reshape(B, J, 4, 4)

    chain = [transforms_mat[:, 0]]
    for i in range(1, J):
        chain.append(torch.matmul(chain[parents[i]], transforms_mat[:, i]))
    transforms = torch.stack(chain, dim=1)  # (B,J,4,4)

    posed_joints = transforms[:, :, :3, 3]

    # rel_transforms = transforms - [0 0 0 | transforms @ joints_homogen]
    joints_homogen = torch.cat(
        [joints, torch.zeros((B, J, 1), dtype=joints.dtype, device=joints.device)],
        dim=2,
    )[..., None]  # (B,J,4,1)
    shifted = torch.matmul(transforms, joints_homogen)  # (B,J,4,1)
    rel_transforms = transforms - torch.cat(
        [torch.zeros((B, J, 4, 3), dtype=transforms.dtype,
                     device=transforms.device), shifted], dim=3
    )
    return posed_joints, rel_transforms


def lbs(
    betas: torch.Tensor,  # (B, n_shape+n_exp)
    pose: torch.Tensor,  # (B, J*3) axis-angle
    v_template: torch.Tensor,  # (V,3)
    shapedirs: torch.Tensor,  # (V,3,n_shape+n_exp)
    posedirs: torch.Tensor,  # (P, V*3)  with P = (J-1)*9
    J_regressor: torch.Tensor,  # (J,V)
    parents: np.ndarray,  # (J,) static
    lbs_weights: torch.Tensor,  # (V,J)
):
    """Linear blend skinning. Returns (verts (B,V,3), posed joints (B,J,3))."""
    B = betas.shape[0]
    J = J_regressor.shape[0]

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    joints = vertices2joints(J_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, J, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B,(J-1)*9)
    pose_offsets = torch.matmul(pose_feature, posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)

    # Skinning: per-vertex 4x4 = lbs_weights @ per-joint transforms.
    T = torch.einsum("vj,bjpq->bvpq", lbs_weights, A)  # (B,V,4,4)
    verts = (
        torch.einsum("bvpk,bvk->bvp", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    )
    return verts, posed_joints


def vertices2landmarks(
    vertices: torch.Tensor,  # (B,V,3)
    faces: torch.Tensor,  # (F,3) int
    lmk_faces_idx: torch.Tensor,  # (L,) or (B,L) int
    lmk_bary_coords: torch.Tensor,  # (L,3) or (B,L,3)
) -> torch.Tensor:
    """Barycentric landmark interpolation -> (B,L,3). Batched (the dynamic
    jaw contour) and shared face indices are both accepted."""
    B = vertices.shape[0]
    if lmk_faces_idx.ndim == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand((B,) + lmk_faces_idx.shape)
    if lmk_bary_coords.ndim == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand((B,) + lmk_bary_coords.shape)
    lmk_faces = faces[lmk_faces_idx.long()].long()  # (B,L,3)
    b = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[b, lmk_faces]  # (B,L,3,3)
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords)


def find_dynamic_lmk_idx_and_bcoords(
    pose: torch.Tensor,  # (B, J*3) full pose
    dynamic_lmk_faces_idx: torch.Tensor,  # (79, 17) int
    dynamic_lmk_bary_coords: torch.Tensor,  # (79, 17, 3)
    neck_kin_chain: np.ndarray,  # static chain of joint indices (neck -> root)
):
    """Pose-dependent jaw-contour landmark selection via the 79-bin LUT
    (reference FLAME.py:117-159, +euler angle). Rounds half to even and
    clips from above only, like the reference."""
    B = pose.shape[0]
    per_joint = pose.reshape(B, -1, 3)
    aa_pose = torch.stack([per_joint[:, int(j)] for j in neck_kin_chain], dim=1)  # (B,C,3)
    rot_mats = batch_rodrigues(aa_pose.reshape(-1, 3)).reshape(B, -1, 3, 3)

    rel_rot_mat = torch.eye(3, dtype=pose.dtype, device=pose.device)[None].expand(B, 3, 3)
    for idx in range(len(neck_kin_chain)):
        rel_rot_mat = torch.matmul(rot_mats[:, idx], rel_rot_mat)

    y_rot_angle = torch.round(
        torch.clamp(rot_mat_to_euler_y(rel_rot_mat) * 180.0 / np.pi, max=39)
    ).to(torch.int64)
    neg_mask = (y_rot_angle < 0).to(torch.int64)
    mask = (y_rot_angle < -39).to(torch.int64)
    neg_vals = mask * 78 + (1 - mask) * (39 - y_rot_angle)
    y_rot_angle = neg_mask * neg_vals + (1 - neg_mask) * y_rot_angle

    return dynamic_lmk_faces_idx[y_rot_angle], dynamic_lmk_bary_coords[y_rot_angle]
