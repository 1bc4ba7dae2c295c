"""Frozen copy, the parts the reference uses, of
smirk_tpu_torch/masking/masking.py at commit 19e99aba3b04, the
benchmark's plain reference; it imports nothing of the program.

Mesh-anchored pixel sampling and mask composition (port of
smirk_tpu/masking/masking.py).

  * `sample_mesh_points`: frontal-facing gate, region probability x
    screen-space area, inverse-CDF face sampling, random barycentrics,
    NDC -> pixel mapping; `coords=` re-samples the same surface points on
    a deformed mesh (the cycle path);
  * `transfer_pixels`: a zeros image with img[src] copied to [dst];
  * `compose_mask`: hull-mask dilation, rendered-mask subtraction, pixel
    hints with multiplicative noise and random 11x11 dropout patches.

Images are NHWC. Every draw comes from an explicit `torch.Generator`; each
function also takes its draws as optional tensors (`u`, `bary`, `noise`,
`drop_centers`), so that a test can hand it the JAX package's draws.

Differences from the JAX package, by design:
  * the face count #{cdf <= u} is `torch.searchsorted(cdf, u,
    right=True)`, which is the same number (the JAX package counts with a
    broadcast compare, which at b32 would materialize 32 x 501 x 10044
    booleans here); its oracles SMIRK_SAMPLE_GUMBEL (gumbel-argmax
    sampling) and SMIRK_DILATE_NAIVE (one square max-pool window) are not
    ported: the port has one sampler and the separable dilation only;
  * `transfer_pixels` resolves destinations hit by several points
    deterministically, the last point wins, which is what XLA's scatter
    does on the CPU (a bare CUDA index_put_ with duplicates leaves the
    winner unspecified).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import geometry

NORMAL_Z_THRESH = 0.05


def triangle_area_xy(fv: torch.Tensor) -> torch.Tensor:
    """Shoelace area of triangles projected on xy. fv (...,3,>=2) -> (...)."""
    x1, y1 = fv[..., 0, 0], fv[..., 0, 1]
    x2, y2 = fv[..., 1, 0], fv[..., 1, 1]
    x3, y3 = fv[..., 2, 0], fv[..., 2, 1]
    return 0.5 * (x1 * y2 + x2 * y3 + x3 * y1 - x2 * y1 - x3 * y2 - x1 * y3).abs()


def random_barycentric(shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                       device=None, u: Optional[torch.Tensor] = None,
                       v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform barycentric coords (..., 3) from two uniform draws u, v
    (reflected when u + v > 1); u and v are drawn from `generator` unless
    given."""
    if u is None:
        u = torch.rand(shape, generator=generator, device=device)
    if v is None:
        v = torch.rand(shape, generator=generator, device=device)
    flip = u + v > 1
    u = torch.where(flip, 1 - u, u)
    v = torch.where(flip, 1 - v, v)
    return torch.stack([1 - (u + v), u, v], dim=-1)


def points_to_pixels(npoints: torch.Tensor, image_size: int) -> torch.Tensor:
    """NDC points (...,>=2) -> integer pixel coords [x, y], int32, clipped."""
    p = 0.5 * (1.0 + npoints[..., :2]) * image_size
    return p.to(torch.int32).clamp(0, image_size - 1)


def interpolate_on_faces(verts: torch.Tensor, faces: torch.Tensor,
                         face_idx: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """verts (B,V,3), faces (F,3), face_idx (B,N), bary (B,N,3) -> (B,N,3)."""
    tri = faces[face_idx.long()]  # (B,N,3)
    b = torch.arange(verts.shape[0], device=verts.device)[:, None, None]
    fv = verts[b, tri]  # (B,N,3,3)
    return torch.einsum("bnc,bncd->bnd", bary, fv)


def face_sampling_probabilities(
    transformed_vertices: torch.Tensor,  # (B,V,3) NDC
    faces: torch.Tensor,  # (F,3)
    face_probabilities: torch.Tensor,  # (F,)
    incidence: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Region probability x frontal-facing gate x screen area -> (B,F)."""
    if incidence is not None:
        normals = geometry.vertex_normals_gather(
            transformed_vertices, faces, incidence[0], incidence[1])
    else:
        normals = geometry.vertex_normals(transformed_vertices, faces)
    nz = geometry.face_vertices(normals, faces)[..., 2]
    # the mean as XLA evaluates it over 3: a sum times 1/3
    fnz = (nz[..., 0] + nz[..., 1] + nz[..., 2]) * (1.0 / 3.0)  # (B,F)
    probs = torch.where(fnz < NORMAL_Z_THRESH, face_probabilities[None], 0.0)
    return probs * triangle_area_xy(geometry.face_vertices(transformed_vertices, faces))


def sample_mesh_points(
    transformed_vertices: torch.Tensor,
    faces: torch.Tensor,
    face_probabilities: torch.Tensor,
    num_points: int,
    image_size: int = 224,
    coords: Optional[Dict[str, torch.Tensor]] = None,
    incidence=None,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    bary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sample pixel locations on the visible face surface.

    -> (pixel points (B,N,2) int32 [x, y], coords {sampled_faces_indices
    (B,N), barycentric_coords (B,N,3)} for re-sampling the same surface
    points on a deformed mesh). Without `coords`, faces are drawn by
    inverse CDF from `face_sampling_probabilities`: u (B,N) uniform in
    [0, 1) is scaled by each image's total, the face is #{cdf <= u},
    clamped to the last positive-probability face (u can round up to the
    total). Rows with no positive probability sample uniformly.
    """
    B = transformed_vertices.shape[0]
    dev = transformed_vertices.device
    if coords is None:
        probs = face_sampling_probabilities(
            transformed_vertices, faces, face_probabilities, incidence)
        total = probs.sum(-1, keepdim=True)
        safe = torch.where(total > 0, probs, 1.0)
        cdf = torch.cumsum(safe, dim=-1)  # (B,F)
        if u is None:
            u = torch.rand((B, num_points), generator=generator, device=dev)
        u = u * cdf[:, -1:]
        face_idx = torch.searchsorted(cdf, u.contiguous(), right=True)
        Fn = safe.shape[-1]
        iota = torch.arange(Fn, device=dev)
        last_pos = torch.where(safe > 0, iota[None], -1).amax(-1, keepdim=True)
        face_idx = torch.minimum(face_idx, last_pos)
        if bary is None:
            bary = random_barycentric((B, num_points), generator, dev)
        coords = {"sampled_faces_indices": face_idx, "barycentric_coords": bary}
    pts = interpolate_on_faces(transformed_vertices, faces,
                               coords["sampled_faces_indices"],
                               coords["barycentric_coords"])
    return points_to_pixels(pts, image_size), coords


def transfer_pixels(
    img: torch.Tensor,  # (B,H,W,C)
    points_src: torch.Tensor,  # (B,N,2) int [x, y]
    points_dst: torch.Tensor,  # (B,N,2)
    valid_count: Optional[torch.Tensor] = None,  # (B,) point budget
) -> torch.Tensor:
    """Zeros image with img[src] copied to [dst]; only the first
    valid_count[b] points of image b are copied. Where several points hit
    one pixel, the last of them wins."""
    B, H, W, C = img.shape
    N = points_src.shape[1]
    dev = img.device
    b = torch.arange(B, device=dev)[:, None]
    src = points_src.long()
    vals = img[b, src[..., 1], src[..., 0]]  # (B,N,C)
    dst = points_dst.long()
    flat = dst[..., 1] * W + dst[..., 0]  # (B,N)
    n_idx = torch.arange(N, device=dev)[None].expand(B, N)
    if valid_count is not None:
        flat = torch.where(n_idx < valid_count[:, None], flat, H * W)
    # the last point that lands on each pixel (-1 = none)
    winner = torch.full((B, H * W + 1), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(1, flat, n_idx, reduce="amax", include_self=True)
    winner = winner[:, :H * W]
    out = vals[b, winner.clamp_min(0)]  # (B,H*W,C)
    out = torch.where((winner >= 0)[..., None], out, 0.0)
    return out.reshape(B, H, W, C)


def _dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation (B,H,W,C): max over a (2r+1)^2 window, stride 1,
    -inf outside the image, as a row pass then a column pass."""
    k = 2 * radius + 1
    x = mask.permute(0, 3, 1, 2)
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(radius, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, radius))
    return x.permute(0, 2, 3, 1)


def compose_mask(
    img: torch.Tensor,  # (B,H,W,C)
    mask: torch.Tensor,  # (B,H,W,1) hull mask, 1 = BACKGROUND
    extra_points: torch.Tensor,  # (B,H,W,C) sparse pixel hints
    dilation_radius: int = 15,
    rendered_mask: Optional[torch.Tensor] = None,  # (B,H,W,1)
    extra_noise: bool = True,
    random_mask: float = 0.01,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    drop_centers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked image = img outside (the dilated face hull minus the render)
    + noisy hints, detached.

    noise (B,H,W,C) standard normal draws (hints are scaled by 1 + 0.05 *
    noise); drop_centers (B,H,W,1) 0/1 Bernoulli(random_mask) draws whose
    11x11 neighbourhoods drop the hints. Both are drawn from `generator`
    unless given.
    """
    B, H, W, C = img.shape
    dev = img.device
    hole = 1.0 - _dilate(1.0 - mask, dilation_radius)
    if rendered_mask is not None:
        hole = hole * (1.0 - rendered_mask)
    masked_img = img * hole

    if extra_noise:
        if noise is None:
            noise = torch.randn(extra_points.shape, generator=generator, device=dev)
        extra_points = extra_points * (noise * 0.05 + 1.0)

    if random_mask > 0:
        if drop_centers is None:
            drop_centers = torch.bernoulli(
                torch.full((B, H, W, 1), random_mask, device=dev), generator=generator)
        extra_points = extra_points * (1.0 - _dilate(drop_centers.to(img.dtype), 5))

    return torch.where(extra_points > 0, extra_points, masked_img).detach()
