"""Image and keypoint transforms of the crop and hull-mask path (a copy of
what the reconstruct path needs from smirk_tpu/data/transforms.py).

  * `estimate_similarity` (Umeyama), `crop_face_tform` (the scale-1.4
    landmark-bbox crop), `transform_points`, `arcface_tform` and
    `MEDIAPIPE_INDICES`: numpy, as in the JAX package;
  * `warp_affine`: B images through B forward matrices, on the images'
    device, in torch: the JAX package's `ndimage.affine_transform(order=1,
    mode="grid-constant")` (bilinear, samples outside the image blend with
    zero) or order 0 (nearest, zero outside), coordinates in float64;
  * `convex_hull_mask`: each point set's hull (Andrew's monotone chain) on
    the host, the pixel-centre half-plane fill batched on the device in
    int64, exact since the points are truncated to int32 first;
  * `crop_faces`: `crop_tforms` (each image's crop matrix and landmarks)
    and `warp_affine`, clipped and divided as the JAX package's callers do.

`warp_affine_np` and `convex_hull_mask_np` state the same functions in
numpy for one image; they are the oracles the device versions are checked
against on the card.

The training data pipeline's host side, numpy and the native host-ops
library (`smirk_tpu_torch.native`; the loader's workers must not touch the
card): `warp_affine_host` (one image; order 1 bilinear, order 0 nearest)
and `convex_hull_mask_host` in the library, `augment` (photometric +
shift-scale-rotate, the JAX package's op order, probabilities and draws
from the caller's numpy Generator), with the hue rotation, the sRGB <-> Lab
helpers, CLAHE (`_clahe`, in the library) and `uniform_filter` (scipy's
box filter with its default reflect boundary, restated without scipy).
`_warp_affine_nearest_np`, `_clahe_np` and `_clahe_apply_u8` (with
`warp_affine_np` and `convex_hull_mask_np` above) are the library's numpy
oracles, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from smirk_tpu_torch import native
from smirk_tpu_torch.device import resolve_device

ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]],
    dtype=np.float32,
)

# 105-of-478 mediapipe landmark subset matching the FLAME mediapipe
# embedding (also stored in the embedding npz)
MEDIAPIPE_INDICES = [
    276, 282, 283, 285, 293, 295, 296, 300, 334, 336, 46, 52, 53,
    55, 63, 65, 66, 70, 105, 107, 249, 263, 362, 373, 374, 380,
    381, 382, 384, 385, 386, 387, 388, 390, 398, 466, 7, 33, 133,
    144, 145, 153, 154, 155, 157, 158, 159, 160, 161, 163, 173, 246,
    168, 6, 197, 195, 5, 4, 129, 98, 97, 2, 326, 327, 358,
    0, 13, 14, 17, 37, 39, 40, 61, 78, 80, 81, 82, 84,
    87, 88, 91, 95, 146, 178, 181, 185, 191, 267, 269, 270, 291,
    308, 310, 311, 312, 314, 317, 318, 321, 324, 375, 402, 405, 409,
    415,
]

# int64 elements of one block of the hull fill's half-plane tests
_FILL_BLOCK_ELEMS = 1 << 25


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama least-squares similarity (rotation+scale+translation).

    src/dst (N,2) -> 3x3 homogeneous matrix mapping src -> dst. Matches
    skimage SimilarityTransform.estimate.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, d])
    R = U @ D @ Vt
    var_s = (sc**2).sum() / len(src)
    scale = np.trace(np.diag(S) @ D) / var_s
    t = mu_d - scale * R @ mu_s
    M = np.eye(3)
    M[:2, :2] = scale * R
    M[:2, 2] = t
    return M


def crop_face_tform(
    landmarks: np.ndarray, scale: float, image_size: int
) -> np.ndarray:
    """Landmark-bbox-centered square crop -> 3x3 similarity matrix."""
    left, right = landmarks[:, 0].min(), landmarks[:, 0].max()
    top, bottom = landmarks[:, 1].min(), landmarks[:, 1].max()
    old_size = (right - left + bottom - top) / 2
    center = np.array([right - (right - left) / 2.0, bottom - (bottom - top) / 2.0])
    size = int(old_size * scale)
    src = np.array(
        [
            [center[0] - size / 2, center[1] - size / 2],
            [center[0] - size / 2, center[1] + size / 2],
            [center[0] + size / 2, center[1] - size / 2],
        ]
    )
    dst = np.array([[0, 0], [0, image_size - 1], [image_size - 1, 0]])
    return estimate_similarity(src, dst)


def transform_points(M: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 3x3 homogeneous matrix to (N,2) points."""
    homo = np.hstack([pts[:, :2], np.ones((len(pts), 1))])
    return (homo @ M.T)[:, :2]


def arcface_tform(landmarks_fan: np.ndarray, image_size: int = 112) -> np.ndarray:
    """5-point similarity to the ArcFace template. landmarks_fan: (68,2);
    returns 3x3 matrix."""
    lmk5 = landmarks_fan[[36, 45, 32, 48, 54]].astype(np.float64).copy()
    lmk5[0] = (landmarks_fan[36] + landmarks_fan[39]) / 2
    lmk5[1] = (landmarks_fan[42] + landmarks_fan[45]) / 2
    ratio = image_size / 112.0
    dst = ARCFACE_DST * ratio
    return estimate_similarity(lmk5, dst)


# ------------------------------ warp ------------------------------


def _source_coords(Minv, xo, yo):
    """Input coordinates (ix, iy) of every output pixel, out(p) = in(Minv p):
    (..., OH, OW) float64 for Minv (..., 3, 3), the output's pixel columns
    xo (OW,) and rows yo (OH, 1)."""
    m = [[Minv[..., i, j][..., None, None] for j in range(3)] for i in range(2)]
    ix = m[0][0] * xo + (m[0][1] * yo + m[0][2])
    iy = m[1][0] * xo + (m[1][1] * yo + m[1][2])
    return ix, iy


def warp_affine(images: torch.Tensor, Ms, out_shape: Tuple[int, int],
                order: int = 1) -> torch.Tensor:
    """Warp each image with its FORWARD 3x3 matrix (out(p) = img(M^-1 p)).

    images (B,H,W,C) on any device; Ms (B,3,3) (numpy or a tensor) ->
    (B,OH,OW,C) float32 on the images' device. order 1: bilinear over the
    image extended by zeros (grid-constant: a sample near the border blends
    with zero, it is not clamped); order 0: nearest (floor(v + 0.5)), zero
    outside. Coordinates and the blend are float64.
    """
    if order not in (0, 1):
        raise ValueError(f"order must be 0 or 1, got {order}")
    B, H, W, C = images.shape
    OH, OW = out_shape
    dev = images.device
    Minv = torch.as_tensor(np.linalg.inv(np.asarray(
        Ms.cpu() if torch.is_tensor(Ms) else Ms, np.float64)), device=dev)
    if Minv.shape != (B, 3, 3):
        raise ValueError(f"Ms must be ({B}, 3, 3), got {tuple(Minv.shape)}")
    ix, iy = _source_coords(Minv, torch.arange(OW, dtype=torch.float64, device=dev),
                            torch.arange(OH, dtype=torch.float64, device=dev)[:, None])
    flat = images.reshape(B, H * W, C)

    def tap(x, y):  # (B,OH,OW) integral float64 coords -> float64 values, 0 outside
        valid = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        idx = (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long().reshape(B, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(B, OH, OW, C)
        return torch.where(valid[..., None], v.to(torch.float64), 0.0)

    if order == 0:
        return tap(torch.floor(ix + 0.5), torch.floor(iy + 0.5)).to(torch.float32)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0)[..., None], (iy - y0)[..., None]
    out = ((1 - fx) * (1 - fy) * tap(x0, y0) + fx * (1 - fy) * tap(x0 + 1, y0)
           + (1 - fx) * fy * tap(x0, y0 + 1) + fx * fy * tap(x0 + 1, y0 + 1))
    return out.to(torch.float32)


def warp_affine_np(image: np.ndarray, M: np.ndarray, out_shape: Tuple[int, int],
                   order: int = 1) -> np.ndarray:
    """`warp_affine` of one (H,W,C) image in numpy (the oracle of the device
    version): the same coordinates, taps and zero extension."""
    img = np.asarray(image, np.float32)
    H, W, C = img.shape
    OH, OW = out_shape
    ix, iy = _source_coords(np.linalg.inv(np.asarray(M, np.float64)),
                            np.arange(OW, dtype=np.float64),
                            np.arange(OH, dtype=np.float64)[:, None])

    def tap(x, y):
        valid = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        v = img[np.clip(y, 0, H - 1).astype(np.int64), np.clip(x, 0, W - 1).astype(np.int64)]
        return np.where(valid[..., None], v.astype(np.float64), 0.0)

    if order == 0:
        return tap(np.floor(ix + 0.5), np.floor(iy + 0.5)).astype(np.float32)
    x0, y0 = np.floor(ix), np.floor(iy)
    fx, fy = (ix - x0)[..., None], (iy - y0)[..., None]
    out = ((1 - fx) * (1 - fy) * tap(x0, y0) + fx * (1 - fy) * tap(x0 + 1, y0)
           + (1 - fx) * fy * tap(x0, y0 + 1) + fx * fy * tap(x0 + 1, y0 + 1))
    return out.astype(np.float32)


# ------------------------------ hull mask ------------------------------


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns CCW hull (y-down image coords). The
    JAX package's `_convex_hull` on integer points, run on Python ints (its
    numpy scalars cost ~1 ms a 105-point set)."""
    pts = sorted(set(map(tuple, np.asarray(pts).tolist())))  # np.unique's order
    if len(pts) <= 2:
        return np.array(pts).reshape(-1, 2)

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                a, b = out[-2], out[-1]
                if (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _hull_of(points: np.ndarray) -> np.ndarray:
    """Hull vertices (n,2) int64 of one point set, its coordinates
    truncated to int32 first (the reference create_mask's cast)."""
    return _convex_hull(np.asarray(points)[:, :2].astype(np.int32).astype(np.int64))


def convex_hull_mask(points: Sequence[np.ndarray], shape: Tuple[int, int],
                     device=None) -> torch.Tensor:
    """(B,H,W) float32 masks on `device` (None: the CUDA card, raising
    without one; "cpu" the CPU), 1 outside the
    convex hull of each image's points, 0 inside (hull region zeroed, the
    reference create_mask polarity): a pixel is inside when its centre
    lies on one side of, or on, every hull edge. Fewer than 3 hull vertices
    (fewer than 3 unique points, or all on a line) -> all ones."""
    device = resolve_device(device)
    hulls = [_hull_of(p) for p in points]
    B, (H, W) = len(hulls), shape
    E = max([len(h) for h in hulls] + [1])
    # edges (x0, y0, x1, y1); padding edges have length 0, e == 0 at every
    # pixel, and so test nothing
    edges = np.zeros((B, E, 4), np.int64)
    filled = np.zeros(B, bool)
    for b, h in enumerate(hulls):
        if len(h) < 3:
            continue
        filled[b] = True
        edges[b, :len(h), :2] = h
        edges[b, :len(h), 2:] = np.roll(h, -1, axis=0)
        edges[b, len(h):] = np.concatenate([h[0], h[0]])
    edges = torch.as_tensor(edges, device=device)
    xx = torch.arange(W, device=device, dtype=torch.int64)[None, None, None, :]
    yy = torch.arange(H, device=device, dtype=torch.int64)[None, None, :, None]
    pos = torch.ones((B, H, W), dtype=torch.bool, device=device)
    neg = torch.ones_like(pos)
    step = max(1, _FILL_BLOCK_ELEMS // max(1, B * H * W))
    for e0 in range(0, E, step):
        x0, y0, x1, y1 = (edges[:, e0:e0 + step, i, None, None] for i in range(4))
        e = (xx - x0) * (y1 - y0) - (yy - y0) * (x1 - x0)  # (B,e,H,W)
        pos &= (e >= 0).all(1)
        neg &= (e <= 0).all(1)
    inside = (pos | neg) & torch.as_tensor(filled, device=device)[:, None, None]
    return torch.where(inside, 0.0, 1.0)


def convex_hull_mask_np(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """`convex_hull_mask` of one point set in numpy (the oracle of the
    device version; the JAX package's numpy fill)."""
    hull = _hull_of(points)
    if len(hull) < 3:
        return np.ones(shape, np.float32)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    pos = np.ones((H, W), bool)
    neg = np.ones((H, W), bool)
    n = len(hull)
    for i in range(n):
        x0, y0 = hull[i]
        x1, y1 = hull[(i + 1) % n]
        e = (xx - x0) * (y1 - y0) - (yy - y0) * (x1 - x0)
        pos &= e >= 0
        neg &= e <= 0
    mask = np.ones(shape, np.float32)
    mask[pos | neg] = 0.0
    return mask


def crop_tforms(landmarks: np.ndarray, image_size: int,
                scale: float = 1.4) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image crop matrices and the landmarks mapped into the crop:
    landmarks (B,K,>=2) -> ((B,3,3) float64, (B,K,2) float32)."""
    landmarks = np.asarray(landmarks)
    tforms = np.stack([crop_face_tform(k[:, :2], scale=scale, image_size=image_size)
                       for k in landmarks])
    kpts = np.stack([transform_points(m, k[:, :2]) for m, k in zip(tforms, landmarks)])
    return tforms, kpts.astype(np.float32)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device (a CUDA division by a Python
    scalar multiplies by its reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def crop_faces(images: torch.Tensor, landmarks: np.ndarray, image_size: int):
    """The scale-1.4 landmark-bbox crop of a batch on its device, as the JAX
    package computes it: clip(warp(images), 0, 255) / 255. images (B,H,W,C)
    float32 on the 0-255 scale; landmarks (B,K,>=2) in their pixels ->
    ((B,S,S,C) float32 in [0,1], (B,3,3) crop matrices, (B,K,2) float32
    landmarks in the crop's pixels)."""
    tforms, kpts = crop_tforms(landmarks, image_size)
    crop = warp_affine(images, tforms, (image_size, image_size)).clamp(0, 255)
    return div_exact(crop, 255.0), tforms, kpts


# ------------------------------ host-side warp ------------------------------


def _warp_affine_nearest_np(image: np.ndarray, M: np.ndarray,
                            out_shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour warp, forward matrix M, zero fill outside: scipy's
    affine_transform(order=0, grid-constant) semantics, floor(v + 0.5)."""
    img = np.asarray(image, np.float32)
    H, W = img.shape[:2]
    OH, OW = out_shape
    Minv = np.linalg.inv(np.asarray(M, np.float64))
    xo = np.arange(OW, dtype=np.float64)
    yo = np.arange(OH, dtype=np.float64)[:, None]
    ix = np.floor(Minv[0, 0] * xo + Minv[0, 1] * yo + Minv[0, 2] + 0.5)
    iy = np.floor(Minv[1, 0] * xo + Minv[1, 1] * yo + Minv[1, 2] + 0.5)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    ixc = np.clip(ix, 0, W - 1).astype(np.int64)
    iyc = np.clip(iy, 0, H - 1).astype(np.int64)
    out = np.where(valid[..., None], img[iyc, ixc], 0.0)
    return out.astype(np.float32)


def warp_affine_host(image: np.ndarray, M: np.ndarray, out_shape: Tuple[int, int],
                     order: int = 1) -> np.ndarray:
    """One (H,W,C) image through its FORWARD 3x3 matrix on the host, in the
    native library: bilinear over the zero-extended image (order 1, the
    function of `warp_affine_np`) or nearest (order 0,
    `_warp_affine_nearest_np`'s)."""
    image = np.asarray(image, np.float32)
    if order == 0:
        return native.warp_affine_nearest(image, M, out_shape)
    if order != 1:
        raise ValueError(f"order {order}: the host warp is bilinear (1) or nearest (0)")
    return native.warp_affine(image, M, out_shape)


def convex_hull_mask_host(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """`convex_hull_mask_np`'s function in the native library (the loader's
    hull fill)."""
    return native.convex_hull_mask(np.asarray(points)[:, :2].astype(np.int32), shape)


# ------------------------------ augmentation ------------------------------


_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _rotate_hue(img: np.ndarray, turns: float) -> np.ndarray:
    """Rotate hue by `turns` of the full circle: rotation about the RGB gray
    axis u=(1,1,1)/sqrt(3) (R = cI + (1-c)uu^T + s[u]x), the linear-RGB
    equivalent of torchvision adjust_hue's HSV shift."""
    a = 2.0 * np.pi * turns
    c, s = np.cos(a), np.sin(a)
    cross = np.array([[0, -1, 1], [1, 0, -1], [-1, 1, 0]], np.float32)
    m = c * np.eye(3, dtype=np.float32) + (1 - c) / 3.0 + (
        s / np.sqrt(3.0)) * cross
    return img @ m.T


# D65 sRGB <-> XYZ matrices of the cv2 RGB2LAB formula (sRGB-gamma input,
# the OpenCV convention the reference's albumentations CLAHE goes through)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_LAB_EPS = 0.008856
_LAB_KAPPA = 903.3


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * np.maximum(c, 0.0) ** (1.0 / 2.4) - 0.055)


def _rgb_to_lab(img: np.ndarray):
    """sRGB float [0,1] -> (L [0,100], a, b), cv2 COLOR_RGB2LAB semantics
    in float instead of cv2's u8 fixed-point tables."""
    xyz = _srgb_to_linear(img.astype(np.float64)) @ _RGB2XYZ.T
    xyz /= np.array([0.950456, 1.0, 1.088754])
    f = np.where(xyz > _LAB_EPS, np.cbrt(np.maximum(xyz, 0)),
                 7.787 * xyz + 16.0 / 116.0)
    L = np.where(xyz[..., 1] > _LAB_EPS,
                 116.0 * f[..., 1] - 16.0, _LAB_KAPPA * xyz[..., 1])
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return L, a, b


def _lab_to_rgb(L: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def _inv(f):
        f3 = f ** 3
        return np.where(f3 > _LAB_EPS, f3, (f - 16.0 / 116.0) / 7.787)

    yr = np.where(L > _LAB_KAPPA * _LAB_EPS,
                  ((L + 16.0) / 116.0) ** 3, L / _LAB_KAPPA)
    xyz = np.stack([_inv(fx) * 0.950456, yr, _inv(fz) * 1.088754], -1)
    lin = np.clip(xyz @ _XYZ2RGB.T, 0.0, 1.0)
    return _linear_to_srgb(lin).astype(np.float32)


def _clahe_apply_u8(channel: np.ndarray, clip_limit: float,
                    tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE over a (H,W) uint8 channel, OpenCV's semantics: integer clip
    limit scaled by the tile area, batch + residual-step redistribution of
    the excess, bilinear interpolation between the 4 surrounding tile LUTs,
    reflect-101 right/bottom padding when the size is not tile-divisible."""
    ch = np.asarray(channel, np.uint8)
    H, W = ch.shape
    tx_n, ty_n = int(tiles[0]), int(tiles[1])
    if W % tx_n == 0 and H % ty_n == 0:
        src = ch
    else:
        pw, ph = tx_n - W % tx_n, ty_n - H % ty_n
        src = np.pad(ch, ((0, ph), (0, pw)), mode="reflect")
    PH, PW = src.shape
    tw, th = PW // tx_n, PH // ty_n
    area = tw * th
    clip = max(1, int(clip_limit * area / 256.0)) if clip_limit > 0 else 0

    tiles_v = src.reshape(ty_n, th, tx_n, tw).transpose(0, 2, 1, 3)
    tile_ids = np.arange(ty_n * tx_n)[:, None, None]
    idx = tile_ids * 256 + tiles_v.reshape(ty_n * tx_n, th, tw)
    hist = np.bincount(idx.ravel(), minlength=ty_n * tx_n * 256).reshape(
        ty_n * tx_n, 256).astype(np.int64)
    if clip > 0:
        clipped = np.maximum(hist - clip, 0).sum(1)
        hist = np.minimum(hist, clip) + (clipped // 256)[:, None]
        residual = clipped - (clipped // 256) * 256
        for t in np.nonzero(residual)[0]:
            r = int(residual[t])
            step = max(1, 256 // r)
            hist[t, np.arange(0, 256, step)[:r]] += 1
    lut = np.rint(np.cumsum(hist, 1) * (255.0 / area))
    lut = np.clip(lut, 0, 255).reshape(ty_n, tx_n, 256)

    # x * (1/tw), not x/tw: the 1-ulp difference flips floor() at exact
    # tile boundaries, and cv2 multiplies
    txf = np.arange(W) * (1.0 / tw) - 0.5
    tx1 = np.floor(txf).astype(np.int64)
    xa = txf - tx1
    tx2 = np.minimum(tx1 + 1, tx_n - 1)
    tx1 = np.maximum(tx1, 0)
    tyf = np.arange(H) * (1.0 / th) - 0.5
    ty1 = np.floor(tyf).astype(np.int64)
    ya = (tyf - ty1)[:, None]
    ty2 = np.minimum(ty1 + 1, ty_n - 1)
    ty1 = np.maximum(ty1, 0)
    v = ch.astype(np.int64)
    r1 = ty1[:, None]
    r2 = ty2[:, None]
    res = ((lut[r1, tx1[None, :], v] * (1 - xa) +
            lut[r1, tx2[None, :], v] * xa) * (1 - ya) +
           (lut[r2, tx1[None, :], v] * (1 - xa) +
            lut[r2, tx2[None, :], v] * xa) * ya)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def _clahe(img: np.ndarray, clip_limit: float) -> np.ndarray:
    """CLAHE on the Lab L channel in the native library (`_clahe_np`'s
    function)."""
    return native.clahe_rgb(np.clip(img, 0.0, 1.0).astype(np.float32), clip_limit)


def _clahe_np(img: np.ndarray, clip_limit: float) -> np.ndarray:
    """CLAHE on the Lab L channel (the reference's albumentations CLAHE,
    which wraps cv2): sRGB-gamma float Lab, u8 quantization on both ends
    and of L to L * 255 / 100, as cv2's u8 pipeline."""
    rgb = np.clip(img, 0.0, 1.0).astype(np.float32)
    rgb_q = np.rint(rgb * 255.0) / 255.0
    L, a, b = _rgb_to_lab(rgb_q)
    l_u8 = np.clip(np.rint(L * (255.0 / 100.0)), 0, 255).astype(np.uint8)
    l_eq = _clahe_apply_u8(l_u8, clip_limit)
    out = _lab_to_rgb(l_eq.astype(np.float64) * (100.0 / 255.0), a, b)
    return (np.rint(out * 255.0) / 255.0).astype(np.float32)


def uniform_filter(img: np.ndarray, k: int) -> np.ndarray:
    """k x k box mean over the two leading axes of an (H,W,C) float32
    image, each channel alone: scipy's `ndimage.uniform_filter(img,
    size=(k, k, 1))` with its default mode "reflect" (d c b a | a b c d,
    numpy's "symmetric"), one axis at a time in float64, rounded to the
    image's dtype after each axis as scipy does. k odd."""
    out = np.asarray(img)
    r = k // 2
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        p = np.pad(out.astype(np.float64), pad, mode="symmetric")
        n = out.shape[axis]
        acc = sum(np.take(p, np.arange(i, i + n), axis=axis) for i in range(k))
        out = (acc / k).astype(img.dtype)
    return out


def augment(
    rng: np.random.Generator,
    image: np.ndarray,  # (H,W,3) float [0,1]
    mask: np.ndarray,  # (H,W) float
    keypoints: np.ndarray,  # (K,2)
    keypoints2: np.ndarray,  # (K2,2)
):
    """Photometric + shift/scale/rotate augmentation with keypoint sync.

    The reference's albumentations pipeline (base_dataset.py:41-52) at the
    libraries' default limits, as the JAX package states it:
    RandomBrightnessContrast(0.5), RandomGamma(0.5), ColorJitter(0.05 x4,
    0.25), CLAHE(0.255), RGBShift(0.25), Blur(0.1), GaussNoise(0.5),
    ShiftScaleRotate(0.05/0.1/10deg, border 0, 0.9); the same draws in the
    same order from `rng`, so one seeded Generator gives the JAX package's
    sample.
    """
    img = image.astype(np.float32)

    if rng.random() < 0.5:  # RandomBrightnessContrast (limits 0.2/0.2)
        img = img * (1 + rng.uniform(-0.2, 0.2)) + rng.uniform(-0.2, 0.2)
    if rng.random() < 0.5:  # RandomGamma (gamma_limit 80..120)
        img = np.clip(img, 0, 1) ** rng.uniform(0.8, 1.2)
    if rng.random() < 0.25:  # ColorJitter(0.05,0.05,0.05,0.05), random order
        for op in rng.permutation(4):
            if op == 0:  # brightness
                img = img * rng.uniform(0.95, 1.05)
            elif op == 1:  # contrast: blend with the mean gray
                f = rng.uniform(0.95, 1.05)
                img = img * f + float((img @ _LUMA).mean()) * (1 - f)
            elif op == 2:  # saturation: blend with per-pixel gray
                f = rng.uniform(0.95, 1.05)
                gray = (img @ _LUMA)[..., None]
                img = img * f + gray * (1 - f)
            else:  # hue
                img = _rotate_hue(img, rng.uniform(-0.05, 0.05))
    if rng.random() < 0.255:  # CLAHE (clip_limit U(1,4), 8x8 tiles)
        img = _clahe(img, rng.uniform(1.0, 4.0))
    if rng.random() < 0.25:  # RGBShift (shift_limit 20/255 per channel)
        img = img + rng.uniform(-20.0, 20.0, 3).astype(np.float32) / 255.0
    if rng.random() < 0.1:  # Blur (box kernel, odd size 3/5/7: an even one
        # would shift the content half a pixel off the keypoints)
        k = 2 * int(rng.integers(1, 4)) + 1
        img = uniform_filter(img, k)
    if rng.random() < 0.5:  # GaussNoise (var_limit 10..50 on the 255 scale)
        std = np.sqrt(rng.uniform(10.0, 50.0)) / 255.0
        img = img + rng.normal(0, std, img.shape)
    img = np.clip(img, 0, 1).astype(np.float32)

    if rng.random() < 0.9:  # shift-scale-rotate
        H, W = img.shape[:2]
        angle = np.deg2rad(rng.uniform(-10, 10))
        scale = 1 + rng.uniform(-0.1, 0.1)
        tx = rng.uniform(-0.05, 0.05) * W
        ty = rng.uniform(-0.05, 0.05) * H
        c, s = np.cos(angle), np.sin(angle)
        cx, cy = W / 2, H / 2
        R = np.array(
            [[scale * c, -scale * s, 0], [scale * s, scale * c, 0], [0, 0, 1]]
        )
        T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
        T2 = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1.0]])
        M = T2 @ R @ T1
        img = warp_affine_host(img, M, (H, W))
        mask = warp_affine_host(mask[..., None], M, (H, W), order=0)[..., 0]
        keypoints = transform_points(M, keypoints)
        keypoints2 = transform_points(M, keypoints2)
        img = np.clip(img, 0, 1).astype(np.float32)

    return img, mask.astype(np.float32), keypoints.astype(np.float32), \
        keypoints2.astype(np.float32)
