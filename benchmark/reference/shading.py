"""Frozen copy, the parts the reference uses, of
smirk_tpu_torch/render/shading.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

Lighting models (port of smirk_tpu/render/shading.py): the renderer's
directional shading on gray albedo; the benchmark keeps only it."""
from __future__ import annotations

import numpy as np
import torch

# reference renderer.py:127-136
DEFAULT_LIGHT_DIRECTIONS = np.array(
    [[-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1], [0, 0, 1]], np.float32
)
DEFAULT_LIGHT_INTENSITY = 1.7
GRAY_ALBEDO = 180.0 / 255.0

def directional_shading(
    normals: torch.Tensor,  # (..., 3) unit normals
    light_directions: np.ndarray = DEFAULT_LIGHT_DIRECTIONS,
    intensity: float = DEFAULT_LIGHT_INTENSITY,
) -> torch.Tensor:
    """Mean over lights of clamp(n . dir, 0, 1) * intensity -> (..., 3).
    The per-light intensity is the same on all channels, so the shading is
    gray."""
    dirs = light_directions / np.linalg.norm(light_directions, axis=-1, keepdims=True)
    dirs = torch.as_tensor(dirs, dtype=normals.dtype, device=normals.device)
    dots = torch.einsum("...k,lk->...l", normals, dirs)
    shade = dots.clamp(0.0, 1.0).mean(dim=-1) * intensity
    return shade[..., None].expand(shade.shape + (3,))
