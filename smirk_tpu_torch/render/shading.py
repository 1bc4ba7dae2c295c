"""Lighting models (port of smirk_tpu/render/shading.py): the renderer's
directional shading on gray albedo, and the reference's point and
spherical-harmonics lighting."""
from __future__ import annotations

import numpy as np
import torch

# reference renderer.py:127-136
DEFAULT_LIGHT_DIRECTIONS = np.array(
    [[-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1], [0, 0, 1]], np.float32
)
DEFAULT_LIGHT_INTENSITY = 1.7
GRAY_ALBEDO = 180.0 / 255.0

# SH constant factors (reference renderer.py:94-98)
_pi = np.pi
SH_CONST = np.array(
    [
        1 / np.sqrt(4 * _pi),
        ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
        ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
        ((2 * _pi) / 3) * np.sqrt(3 / (4 * _pi)),
        (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
        (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
        (_pi / 4) * 3 * np.sqrt(5 / (12 * _pi)),
        (_pi / 4) * (3 / 2) * np.sqrt(5 / (12 * _pi)),
        (_pi / 4) * (1 / 2) * np.sqrt(5 / (4 * _pi)),
    ],
    np.float32,
)


def unit_directions(light_directions: np.ndarray = DEFAULT_LIGHT_DIRECTIONS) -> np.ndarray:
    """(L,3) light directions -> the same, each of unit length."""
    return light_directions / np.linalg.norm(light_directions, axis=-1, keepdims=True)


def directional_shading(
    normals: torch.Tensor,  # (..., 3) unit normals
    light_directions: torch.Tensor,  # (L,3) unit directions on the normals' device
    intensity: float = DEFAULT_LIGHT_INTENSITY,
) -> torch.Tensor:
    """Mean over lights of clamp(n . dir, 0, 1) * intensity -> (..., 3).
    The per-light intensity is the same on all channels, so the shading is
    gray. The renderer holds `unit_directions()` as a buffer."""
    dots = torch.einsum("...k,lk->...l", normals, light_directions.to(normals.dtype))
    shade = dots.clamp(0.0, 1.0).mean(dim=-1) * intensity
    return shade[..., None].expand(shade.shape + (3,))


def point_shading(vertices: torch.Tensor, normals: torch.Tensor,
                  light_positions: torch.Tensor,
                  light_intensities: torch.Tensor) -> torch.Tensor:
    """Reference add_pointlight (renderer.py:224-236): the mean over lights
    of the unclamped n . l times the light's intensity. vertices and
    normals (B,N,3), light_positions and light_intensities (B,L,3) ->
    (B,N,3)."""
    d = light_positions[:, :, None, :] - vertices[:, None, :, :]
    d = d / torch.linalg.norm(d, dim=3, keepdim=True).clamp_min(1e-12)
    ndl = (normals[:, None, :, :] * d).sum(3)
    return (ndl[..., None] * light_intensities[:, :, None, :]).mean(1)


def sh_shading(normal_images: torch.Tensor, sh_coeff: torch.Tensor) -> torch.Tensor:
    """Reference add_SHlight (renderer.py:209-222). normal_images (B,H,W,3),
    sh_coeff (B,9,3) -> (B,H,W,3)."""
    N = normal_images
    sh = torch.stack(
        [
            torch.ones_like(N[..., 0]),
            N[..., 0],
            N[..., 1],
            N[..., 2],
            N[..., 0] * N[..., 1],
            N[..., 0] * N[..., 2],
            N[..., 1] * N[..., 2],
            N[..., 0] ** 2 - N[..., 1] ** 2,
            3 * (N[..., 2] ** 2) - 1,
        ],
        dim=-1,
    ) * torch.as_tensor(SH_CONST, dtype=N.dtype, device=N.device)
    return torch.einsum("bhwk,bkc->bhwc", sh, sh_coeff)
