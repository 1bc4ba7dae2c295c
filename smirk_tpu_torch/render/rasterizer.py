"""Rasterizer: binning, face records, the fused inference z-buffer, the
coverage rasters and the differentiable raster for any number of
attribute channels.

Port of smirk_tpu/render/rasterizer.py. The output contract is the JAX
package's: pixel-to-face ids, z-buffer, per-tile bin slots, interpolated
attributes, and the `raster_overflow` count of compact chunks dropped past
the budget, with the same drop order and tie-breaks.

NDC convention: +x -> right (column), +y -> down (row), pixel (r, c)
centre at ((2c+1-W)/W, (2r+1-H)/H); smaller z is closer. Background is
pix_to_face = -1 and zbuf = 1e10.

Pipeline (`rasterize_normals_fused`):
1. `bin_faces` (the dispatch of `set_bin_mode`'s mode): `bin_faces_flat`
   tests the bounding box of every face against every 8x128 pixel tile,
   then a top-k per tile keeps the `capacity` nearest overlapping faces
   (near-to-far priority: a 255-bucket mean z, then the face id). Bins are
   -1 padded; the tile count is padded to a multiple of 8.
   `bin_faces_hier` (per-band candidates, then tiles) and
   `bin_faces_sorted` (one sort of (tile, priority) incidence keys) give
   the same bins. The approximate mode's selector (`approx_max_k`) is
   exact here, as the JAX package's lowering of its TPU primitive is on
   the CPU and GPUs; `selection_misses` counts the overlapping faces a
   selector drops, which the rasters' `bin_miss_check` adds to overflow.
2. `face_records_shaded`: one 32-lane record per face with its three
   sign-normalized edge functions, its depth plane and its three normal
   planes, all affine in the pixel centre.
3. `_windows`: each tile's kept chunk count. Compact layout (`compact`
   set): the plan's windows over one list of occupied 32-face chunks per
   image, clipped to the budget (`_compact_windows`; the chunks past it
   are the `overflow`). Padded layout (`compact=None`): ceil(count / 32).
   The two layouts differ only in these counts.
4. `raster_fused_windows` (kernel K1): per tile, walk chunks 0 .. kept - 1
   of the tile's bin, reading each face's record from the image's record
   table through its bin id (the TPU's packing kernel K2 and the record
   gather are folded into this staging), skip per warp the faces whose
   bounding box (`cull_boxes`, computed in the kernel from the vertices)
   misses the warp's pixels, keep the nearest covering face (first in slot
   order on ties), and evaluate its normal planes at the pixel.
   `compact_faces_plain` states K2's contract for the checks.
The padded layout has two scheduled variants: `merged` (K9,
`raster_fused_groups`, whose contract is the merged schedule: every tile
of a group of `tps` walks to the group's largest bin) and `sort_tiles`
(K10, `raster_fused_groups_local`: tiles count-sorted, records rebased to
tile-local coordinates, outputs un-permuted). Both kernels read the
records through the bins as K1 does and walk each tile's own chunks (the
group's further chunks hold kill records only); K10 rebases each record
as it stages it. `rasterize_normals_chunkskip` bins fixed chunks of a
(Morton-ordered, `spatial_face_order`) face list instead of faces
(`bin_chunks`) and walks each tile's chunk list over the image's full
record table (K11, `raster_chunkskip`, with K1's staging and cull): no
plan.
`set_backface_cull` drops one winding at the binning stage.

The coverage rasters: `rasterize_coverage_jnp` (all pairs, plain
PyTorch), `rasterize_coverage_pallas_v3[_full]` (`coverage_records` read
through the padded layout's bins, `raster_coverage_windows`, kernel K6:
K3's walk and cull without the planes; pix_to_face, zbuf and the per-tile
slot) and `rasterize_coverage_pallas` (`raster_bins_coverage`,
kernel K8: one face at a time per tile, division barycentrics, with a
per-warp cull whose boxes, `cull_boxes_bins`, are made exact for its
cross-product arithmetic).
`rasterize_coverage` takes K6 on the card and the all-pairs version on the
CPU.

The differentiable raster (`rasterize`). For D <= 6 attribute channels,
`rasterize_planes_diff`, a torch.autograd.Function, bins and plans the
same way, with a training record per face (edge and depth planes, the
face id, D attribute planes). Forward: `raster_planes_windows` (K3) reads
the records through the bins and culls per warp as K1 does, and keeps the
nearest face, its per-tile slot and its D interpolated planes.
Backward: the value cotangent goes tile-major, `segment_moments_to_faces`
(K4 with its fold epilogue) sums [g*x | g*y | g] per (tile, slot) and adds
each won slot's sums into its face (the JAX package's
`segment_reduce_moments` then `fold_slots_to_faces`, K4's store epilogue
and K5, without the per-slot table), and autograd of `attr_planes` takes it to the vertices
and attributes. For D > 6, K6 gives the coverage and
`interpolate_attributes_fast` interpolates by per-pixel gathers; its
backward reduces the per-pixel gradients per (tile, slot) with
`segment_reduce_tiles` (K7) and folds them into faces with K5.
`set_fold_mode` swaps both folds (K4's fold epilogue, and K5) for PyTorch
ops: one index_add_, a sorted one, or prefix-sum differences.

K1 and K3-K11 are CUDA kernels (csrc/; K2 has none, its packing being
folded into K1's and K3's staging). Each wrapper checks its arguments,
launches on PyTorch's current stream and counts its launches; for tensors
on the CPU it runs the plain PyTorch version beside it. K1's wrapper does
so through a torch custom op (`K1_OP`), so that `torch.export` traces the
inference and reconstruct paths whole (`smirk_tpu_torch.serving`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smirk_tpu_torch import kernels
from smirk_tpu_torch.utils.profiling import span

AREA_EPS = 1e-10  # degenerate-triangle guard
BIG_Z = 1e10
TILE_ROWS = 8
TILE_COLS = 128
TILE_PIX = TILE_ROWS * TILE_COLS
V3_CHUNK = 32  # faces per chunk
RECF_LANES = 32  # [9 edge | 3 zplane | fid | pad | 9 normal-plane | pad]
# elements per intermediate array of the plain z-buffer; bounds its memory
_PLAIN_BLOCK_ELEMS = 1 << 25


def _ndc(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel index -> NDC centre, (2i + 1 - size) / size (the JAX
    package's `_pixel_centers`, also for the padding columns of the last
    tile). The divisor is a tensor so that the division is IEEE on every
    device (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal)."""
    num = 2.0 * idx.to(torch.float32) + 1.0 - size
    return num / torch.full_like(num, float(size))


# Backface culling at the binning stage (the JAX package's switch). None =
# off: both windings rasterize. +1/-1 = keep only faces whose screen-space
# signed area has that sign; `bin_faces_flat` and `bin_chunks` drop the
# others.
_CULL_SIGN: Optional[int] = None


def set_backface_cull(sign: Optional[int]) -> None:
    global _CULL_SIGN
    if sign not in (None, 1, -1):
        raise ValueError(f"backface cull sign must be None, 1 or -1, got {sign!r}")
    _CULL_SIGN = sign


def _bbox_and_priority(face_verts: torch.Tensor, image_size: int):
    """Pixel-space bboxes + unique near-to-far priority per face + keep mask.

    Priority = 255-bucket quantized mean z, then face id, so that ties keep
    first-face-wins order within a bucket. keep (B,F) bool is the backface
    cull's (None when culling is off)."""
    H = W = image_size
    F = face_verts.shape[1]
    x = face_verts[..., 0]
    y = face_verts[..., 1]
    keep = None
    if _CULL_SIGN is not None:
        # 2x the signed NDC area; the pixel mapping scales positively, so
        # its sign is the screen-space winding
        area2 = (x[..., 0] * (y[..., 1] - y[..., 2])
                 + x[..., 1] * (y[..., 2] - y[..., 0])
                 + x[..., 2] * (y[..., 0] - y[..., 1]))
        keep = (area2 * _CULL_SIGN) > 0  # (B,F)
    # NDC -> continuous pixel coords (pixel r centre at r + 0.5)
    px = (x * W + W - 1.0) / 2.0
    py = (y * H + H - 1.0) / 2.0
    xmin, xmax = px.amin(-1), px.amax(-1)  # (B,F)
    ymin, ymax = py.amin(-1), py.amax(-1)
    z = face_verts[..., 2]
    # the mean as XLA evaluates jnp.mean over 3: ((z0 + z1) + z2) * (1/3),
    # so that priorities, and with them bin order and tie-breaks, agree
    zmean = (z[..., 0] + z[..., 1] + z[..., 2]) * (1.0 / 3.0)  # (B,F)
    zlo = zmean.amin(-1, keepdim=True)
    zhi = zmean.amax(-1, keepdim=True)
    NB = 255
    zbucket = (
        (zmean - zlo) / (zhi - zlo).clamp_min(1e-12) * NB
    ).clamp(0, NB).to(torch.int32)  # (B,F), 0 = closest
    prio = zbucket * F + torch.arange(F, dtype=torch.int32, device=face_verts.device)[None]
    return xmin, xmax, ymin, ymax, prio, (NB + 2) * F, keep


def _tile_overlap(face_verts: torch.Tensor, image_size: int):
    """-> (overlap (B,T,F) bool: the face's bbox meets the tile's pixel-centre
    range and the face survives the backface cull, prio (B,F), prio_span),
    tiles row-major over the ceil(H/8) x ceil(W/128) grid."""
    B, F = face_verts.shape[:2]
    ty, tx = _tile_grid(image_size)
    xmin, xmax, ymin, ymax, prio, prio_span, keep = _bbox_and_priority(
        face_verts, image_size)
    dev = face_verts.device
    tile_r0 = (torch.arange(ty, device=dev) * TILE_ROWS).to(torch.float32)
    tile_c0 = (torch.arange(tx, device=dev) * TILE_COLS).to(torch.float32)
    ov_r = (ymax[:, None, :] >= tile_r0[None, :, None]) & (
        ymin[:, None, :] <= tile_r0[None, :, None] + TILE_ROWS - 1)  # (B,ty,F)
    ov_c = (xmax[:, None, :] >= tile_c0[None, :, None]) & (
        xmin[:, None, :] <= tile_c0[None, :, None] + TILE_COLS - 1)  # (B,tx,F)
    overlap = (ov_r[:, :, None, :] & ov_c[:, None, :, :]).reshape(B, ty * tx, F)
    if keep is not None:
        overlap = overlap & keep[:, None, :]
    return overlap, prio, prio_span


def _pad_bins(bins, counts, capacity, k, T):
    """Pad the slot axis to `capacity` and the tile axis to a multiple of 8."""
    B = bins.shape[0]
    if k < capacity:
        bins = torch.cat(
            [bins, bins.new_full((B, T, capacity - k), -1)], dim=-1)
    Tp = -(-T // 8) * 8
    if Tp != T:
        bins = torch.cat([bins, bins.new_full((B, Tp - T, capacity), -1)], dim=1)
        counts = torch.cat([counts, counts.new_zeros((B, Tp - T))], dim=1)
    return bins, counts


def selection_misses(pre: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """Overlapping faces the selector failed to return: pre (B, ...) the
    overlap count per tile (or per band) before selection, counts the
    valid count after it, k the selection width -> (B,) int32, the sum
    over tiles of max(min(pre, k) - counts, 0). A capacity overflow (pre
    > k with k returned) is no miss. `bin_faces_hier`'s coarse stage
    counts a missed face once per band, however many of the band's tiles
    it overlaps, so its total is a lower bound in other units than the
    flat path's."""
    per_tile = (pre.clamp(max=k) - counts).clamp_min(0)
    return per_tile.reshape(per_tile.shape[0], -1).sum(-1, dtype=torch.int32)


def approx_max_k(x: torch.Tensor, k: int, recall_target: float):
    """The selector of the approximate binning: -> (values, indices) of the
    k largest entries of x's last axis, largest first. The JAX package
    calls `jax.lax.approx_max_k`, a TPU primitive that XLA lowers to an
    exact top-k on the CPU and on GPUs; this is that exact top-k, so
    `recall_target` changes nothing here. Every approximate selection of
    the binning goes through this one function, so that a test can put
    a lossy selector in its place."""
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)


def _select(overlap, prio_key, key_span: int, k: int, approx):
    """The k highest-priority overlapping entries of the last axis:
    overlap (..., N) bool, prio_key (N,)-broadcastable int32 in [1,
    key_span] (higher = nearer) -> (valid (..., k) bool, idx (..., k)
    int64). One top-k over the int32 key overlap * key_span + prio_key -
    key_span, which is positive exactly where the entry overlaps and
    unique among those: exact with `approx` None, else through
    `approx_max_k` with `approx` its recall target."""
    key = overlap.to(torch.int32) * key_span + (prio_key - key_span)
    if approx is None:
        vals, idx = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    else:
        vals, idx = approx_max_k(key, k, recall_target=approx)
    return vals > 0, idx


def bin_faces_flat(
    face_verts: torch.Tensor, image_size: int, capacity: int,
    approx: Optional[float] = None,
    with_misses: bool = False,
):
    """Assign triangles to pixel tiles by bounding box.

    -> (bins (B,Tp,C) int32 -1 padded, counts (B,Tp) int32[, misses (B,)
    int32]), where T = ceil(H/8) * ceil(W/128) and Tp rounds T up to a
    multiple of 8. Each tile keeps its `capacity` nearest overlapping
    faces, nearest first: a top-k over all F faces of the key overlap *
    prio_span - prio. approx (None: the module's `set_bin_mode` value) is
    the JAX package's `approx_max_k` recall target; the port's selector
    (`approx_max_k`) is exact, so the bins are the exact ones either way.
    with_misses appends `selection_misses` of the overlap counts before
    selection. Faces the backface cull drops (`set_backface_cull`) bin
    nowhere.
    """
    F = face_verts.shape[1]
    overlap, prio, prio_span = _tile_overlap(face_verts, image_size)
    T = overlap.shape[1]
    k = min(capacity, F)
    if approx is None:
        approx = _BIN_APPROX
    valid, idx = _select(overlap, (prio_span - prio)[:, None, :], prio_span, k, approx)
    bins = torch.where(valid, idx.to(torch.int32), -1)
    counts = valid.sum(-1, dtype=torch.int32)  # (B,T)
    padded = _pad_bins(bins, counts, capacity, k, T)
    if with_misses:
        pre = overlap.sum(-1, dtype=torch.int32)  # (B,T)
        return (*padded, selection_misses(pre, counts, k))
    return padded


# Hierarchical binning: BAND_TILES tile rows (32 px) per coarse band, and
# the coarse candidate list's length per band
BAND_TILES = 4
COARSE_CAPACITY = 1024


def bin_faces_hier(
    face_verts: torch.Tensor,
    image_size: int,
    capacity: int,
    band_tiles: int = BAND_TILES,
    coarse_capacity: int = COARSE_CAPACITY,
    approx: Optional[float] = None,
    with_misses: bool = False,
):
    """Two-level binning with `bin_faces_flat`'s output contract.

    The coarse stage keeps, per band of `band_tiles` tile rows, the
    `coarse_capacity` nearest faces whose box meets the band (a top-k over
    all F faces for ceil(ty / band_tiles) rows instead of ty * tx); the
    top-k returns them nearest first. The fine stage picks each tile's
    faces from its band's candidates with the candidate's position as the
    priority (a top-k over coarse_capacity), so a tile keeps the same
    nearest faces as the flat binning, and its exact variant gives the
    flat bins and counts. approx as `bin_faces_flat` (both stages select
    through `approx_max_k`); with_misses counts both stages' misses (the
    coarse one per band, see `selection_misses`).
    """
    B, F = face_verts.shape[:2]
    ty, tx = _tile_grid(image_size)
    T = ty * tx
    nb = -(-ty // band_tiles)
    dev = face_verts.device
    xmin, xmax, ymin, ymax, prio, prio_span, keep = _bbox_and_priority(
        face_verts, image_size)

    # coarse: faces -> bands of band_tiles * TILE_ROWS pixel rows
    band_rows = band_tiles * TILE_ROWS
    band_r0 = (torch.arange(nb, device=dev) * band_rows).to(torch.float32)
    ov_band = (ymax[:, None, :] >= band_r0[None, :, None]) & (
        ymin[:, None, :] <= band_r0[None, :, None] + band_rows - 1)  # (B,nb,F)
    if keep is not None:
        ov_band = ov_band & keep[:, None, :]
    C1 = min(coarse_capacity, F)
    if approx is None:
        approx = _BIN_APPROX
    valid_c, cand = _select(ov_band, (prio_span - prio)[:, None, :], prio_span, C1, approx)

    def gather_bf(a):  # (B,F) -> (B,nb,C1)
        return torch.gather(a[:, None, :].expand(B, nb, F), 2, cand)

    cxmin, cxmax = gather_bf(xmin), gather_bf(xmax)
    cymin, cymax = gather_bf(ymin), gather_bf(ymax)

    # fine: a band's candidates -> its 8x128 tiles
    sub_r0 = band_r0[:, None] + (torch.arange(band_tiles, device=dev)
                                 * TILE_ROWS).to(torch.float32)[None, :]  # (nb,bt)
    ov_r = (cymax[:, :, None, :] >= sub_r0[None, :, :, None]) & (
        cymin[:, :, None, :] <= sub_r0[None, :, :, None] + TILE_ROWS - 1)  # (B,nb,bt,C1)
    tile_c0 = (torch.arange(tx, device=dev) * TILE_COLS).to(torch.float32)
    ov_c = (cxmax[:, :, None, :] >= tile_c0[None, None, :, None]) & (
        cxmin[:, :, None, :] <= tile_c0[None, None, :, None] + TILE_COLS - 1)  # (B,nb,tx,C1)
    ov = (ov_r[:, :, :, None, :] & ov_c[:, :, None, :, :]
          & valid_c[:, :, None, None, :])  # (B,nb,bt,tx,C1)
    k = min(capacity, C1)
    pos_key = C1 - torch.arange(C1, dtype=torch.int32, device=dev)  # nearer = larger
    valid_f, idx_f = _select(ov, pos_key, C1 + 1, k, approx)
    ids = torch.gather(cand[:, :, None, None, :].expand(B, nb, band_tiles, tx, C1),
                       -1, idx_f)
    bins = torch.where(valid_f, ids.to(torch.int32), -1)
    counts_full = valid_f.sum(-1, dtype=torch.int32)  # (B,nb,bt,tx)
    # (B, nb * bt, tx, ...) -> the bands' padding rows cropped -> (B, T, ...)
    bins = bins.reshape(B, nb * band_tiles, tx, k)[:, :ty].reshape(B, T, k)
    counts = counts_full.reshape(B, nb * band_tiles, tx)[:, :ty].reshape(B, T)
    padded = _pad_bins(bins, counts, capacity, k, T)
    if with_misses:
        # a coarse miss drops the face from every tile of its band, a fine
        # one from one tile; the fine counts only over the cropped tiles
        miss_c = selection_misses(ov_band.sum(-1, dtype=torch.int32),
                                  valid_c.sum(-1, dtype=torch.int32), C1)
        pre_f = ov.sum(-1, dtype=torch.int32)
        per_f = (pre_f.clamp(max=k) - counts_full).clamp_min(0)
        miss_f = per_f.reshape(B, nb * band_tiles, tx)[:, :ty].reshape(B, -1).sum(
            -1, dtype=torch.int32)
        return (*padded, miss_c + miss_f)
    return padded


def bin_faces_sorted(
    face_verts: torch.Tensor, image_size: int, capacity: int,
    max_row_span: int = 8, max_col_span: int = 4,
    with_misses: bool = False,
):
    """Sort-based exact binning with `bin_faces_flat`'s output contract,
    built per (face, tile) incidence instead of a top-k over all F faces
    for every tile.

    Each face expands to NI = max_row_span x min(tx, max_col_span)
    incidence keys tile * prio_span + prio (unique, int32); one ascending
    sort per image lays each tile's faces out nearest first, back to back;
    a batched searchsorted over the T + 1 tile boundaries gives each
    tile's run, one take_along_dim its first min(run, capacity) keys, and
    key % F the face id (prio = zbucket * F + id, and tile * prio_span is
    a multiple of F). The bins and counts equal the exact flat binning's,
    capacity drops included, wherever no face is clipped: a face whose box
    spans more tile rows or columns than the spans keeps its first
    (top / left) ones, and with_misses counts the dropped incidences.
    """
    B, F = face_verts.shape[:2]
    ty, tx = _tile_grid(image_size)
    T = ty * tx
    dev = face_verts.device
    xmin, xmax, ymin, ymax, prio, prio_span, keep = _bbox_and_priority(
        face_verts, image_size)
    if T * prio_span >= 2 ** 31:
        raise ValueError(f"bin_faces_sorted: {T} tiles x {prio_span} priorities "
                         "overflow the int32 keys")

    # inclusive tile spans, bin_faces_flat's overlap test: tile row r
    # overlaps iff ymax >= 8r and ymin <= 8r + 7. lo clips to [0, ty] and
    # hi to ty - 1, so that an off-screen face has hi < lo (clamping lo
    # down would bin it into the last row)
    rlo = torch.ceil((ymin - (TILE_ROWS - 1)) / TILE_ROWS).to(torch.int32).clamp(0, ty)
    rhi = torch.floor(ymax / TILE_ROWS).to(torch.int32).clamp(max=ty - 1)
    clo = torch.ceil((xmin - (TILE_COLS - 1)) / TILE_COLS).to(torch.int32).clamp(0, tx)
    chi = torch.floor(xmax / TILE_COLS).to(torch.int32).clamp(max=tx - 1)

    NIR = max_row_span
    NIC = min(tx, max_col_span)
    NI = NIR * NIC
    r = rlo[..., None] + torch.arange(NIR, dtype=torch.int32, device=dev)  # (B,F,NIR)
    c = clo[..., None] + torch.arange(NIC, dtype=torch.int32, device=dev)  # (B,F,NIC)
    valid = (r <= rhi[..., None])[..., :, None] & (c <= chi[..., None])[..., None, :]
    if keep is not None:
        valid = valid & keep[..., None, None]
    key = (r[..., :, None] * tx + c[..., None, :]) * prio_span + prio[..., None, None]
    key = torch.where(valid, key, torch.iinfo(torch.int32).max).reshape(B, F * NI)
    skey = torch.sort(key, dim=-1).values  # ascending: (tile, nearest first) runs

    bounds = (torch.arange(T + 1, dtype=torch.int32, device=dev) * prio_span).expand(B, T + 1)
    starts = torch.searchsorted(skey, bounds.contiguous())  # (B,T+1)
    k = min(capacity, F)
    counts = (starts[:, 1:] - starts[:, :-1]).clamp(max=k).to(torch.int32)  # (B,T)
    slot = torch.arange(k, device=dev)
    idx = (starts[:, :-1, None] + slot).clamp(max=F * NI - 1)  # (B,T,k)
    got = torch.take_along_dim(skey, idx.reshape(B, T * k), dim=1).reshape(B, T, k)
    bins = torch.where(slot < counts[..., None], got % F, -1).to(torch.int32)
    padded = _pad_bins(bins, counts, capacity, k, T)
    if with_misses:
        # span clipping is this path's only selection loss (a capacity
        # overflow is the shared drop, counted apart)
        lost_r = (rhi - rlo + 1 - NIR).clamp_min(0)
        ncols = (chi - clo + 1).clamp_min(0)
        lost_c = (chi - clo + 1 - NIC).clamp_min(0)
        nrows_kept = (rhi - rlo + 1).clamp(0, NIR)
        lost = lost_r * ncols + lost_c * nrows_kept
        if keep is not None:
            lost = torch.where(keep, lost, 0)
        lost = torch.where((rhi >= rlo) & (chi >= clo), lost, 0)
        return (*padded, lost.sum(-1, dtype=torch.int32))
    return padded


# The binning mode, process globals as in the JAX package (which bakes them
# into a program when it traces it): `set_bin_mode` sets them, `bin_faces`
# reads them at each call (a `torch.export` artifact holds the mode of its
# export). Hierarchical binning (measured slower than flat on the TPU, kept
# for reference); the recall target of the approximate selection (None =
# exact; the port's selector is exact either way); sort-based binning.
_BIN_HIER = False
_BIN_APPROX: Optional[float] = None
_BIN_SORTED = False


def set_bin_mode(hier: bool, approx: Optional[float] = None,
                 sorted_: bool = False) -> None:
    """The JAX package's binning switch: hierarchical binning in the
    dispatch (`bin_faces`), the recall target `bin_faces_flat` and
    `bin_faces_hier` fall back to, and sort-based binning (which wins over
    hier)."""
    global _BIN_HIER, _BIN_APPROX, _BIN_SORTED
    _BIN_HIER = hier
    _BIN_APPROX = approx
    _BIN_SORTED = sorted_


def modes() -> tuple:
    """The process-wide switches a raster reads at its call: the binning
    mode and the backface cull."""
    return _BIN_HIER, _BIN_APPROX, _BIN_SORTED, _CULL_SIGN


def bin_faces(face_verts: torch.Tensor, image_size: int, capacity: int,
              approx: Optional[float] = None, with_misses: bool = False):
    """The binning dispatch -> (bins, counts[, misses (B,) int32]):
    `bin_faces_sorted` in the sorted mode; `bin_faces_hier` in the hier
    mode where the coarse list is a real reduction (F > 2 x
    COARSE_CAPACITY) and the image has more than one band of tiles;
    `bin_faces_flat` otherwise. Every raster bins through here, inside the
    `smirk.render.bin` span."""
    F = face_verts.shape[1]
    ty = -(-image_size // TILE_ROWS)
    with span("smirk.render.bin"):
        if _BIN_SORTED:
            return bin_faces_sorted(face_verts, image_size, capacity,
                                    with_misses=with_misses)
        if _BIN_HIER and F > 2 * COARSE_CAPACITY and ty > BAND_TILES:
            return bin_faces_hier(face_verts, image_size, capacity,
                                  approx=approx, with_misses=with_misses)
        return bin_faces_flat(face_verts, image_size, capacity, approx, with_misses)


def _tile_grid(image_size: int):
    """-> (tile rows ty, tile columns tx) of an image."""
    return -(-image_size // TILE_ROWS), -(-image_size // TILE_COLS)


def _tiles_to_image(x: torch.Tensor, image_size: int) -> torch.Tensor:
    """(B,Tp,1024) tile-major -> (B,H,W) image (padding tiles, rows and
    columns cropped)."""
    B = x.shape[0]
    ty, tx = _tile_grid(image_size)
    x = x[:, :ty * tx].reshape(B, ty, tx, TILE_ROWS, TILE_COLS)
    x = x.permute(0, 1, 3, 2, 4).reshape(B, ty * TILE_ROWS, tx * TILE_COLS)
    return x[:, :image_size, :image_size]


def face_records(face_verts: torch.Tensor) -> torch.Tensor:
    """(B,F,3,3) -> (B,F,16) edge/z-plane coefficient records.

    Edge functions e_i(p) = a_i*x + b_i*y + c_i, sign-normalized by the
    face's winding so that inside is e_i >= 0 for either winding; depth is
    the plane z(p) = zA*x + zB*y + zC. Degenerate faces get a never-inside
    record (c0 = -1).
    """
    x0, y0, z0 = face_verts[..., 0, 0], face_verts[..., 0, 1], face_verts[..., 0, 2]
    x1, y1, z1 = face_verts[..., 1, 0], face_verts[..., 1, 1], face_verts[..., 1, 2]
    x2, y2, z2 = face_verts[..., 2, 0], face_verts[..., 2, 1], face_verts[..., 2, 2]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - y1 * x2
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - y2 * x0
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - y0 * x1
    denom = a0 * x0 + b0 * y0 + c0
    valid = denom.abs() >= AREA_EPS
    s = torch.where(denom >= 0, 1.0, -1.0)
    inv = 1.0 / torch.where(valid, denom.abs(), 1.0)
    coeffs = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], -1) * s[..., None]
    zplane = (
        coeffs[..., 0:3] * z0[..., None]
        + coeffs[..., 3:6] * z1[..., None]
        + coeffs[..., 6:9] * z2[..., None]
    ) * inv[..., None]
    pad = face_verts.new_zeros(face_verts.shape[:-2] + (4,))
    rec = torch.cat([coeffs, zplane, pad], dim=-1)
    kill = face_verts.new_zeros((16,))
    kill[2:3].fill_(-1.0)  # on the device: `kill[2] = -1.0` copies a host scalar in
    return torch.where(valid[..., None], rec, kill)


def attr_planes(face_verts: torch.Tensor, attributes: torch.Tensor) -> torch.Tensor:
    """Per-face affine plane coefficients of interpolated attributes.

    (B,F,3,3) verts + (B,F,3,D) corner attributes -> (B,F,3D) laid out
    [PA(D) | PB(D) | PC(D)] with val_d(p) = PA_d*x + PB_d*y + PC_d
    (barycentric interpolation is affine over the face).
    """
    x0, y0 = face_verts[..., 0, 0], face_verts[..., 0, 1]
    x1, y1 = face_verts[..., 1, 0], face_verts[..., 1, 1]
    x2, y2 = face_verts[..., 2, 0], face_verts[..., 2, 1]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - y1 * x2
    denom = a0 * x0 + b0 * y0 + c0
    valid = denom.abs() >= AREA_EPS
    inv = 1.0 / torch.where(valid, denom, 1.0)  # signed: w_i = e_i/denom
    coeffs = torch.stack(
        [
            y1 - y2, x2 - x1, x1 * y2 - y1 * x2,
            y2 - y0, x0 - x2, x2 * y0 - y2 * x0,
            y0 - y1, x1 - x0, x0 * y1 - y0 * x1,
        ],
        -1,
    ) * inv[..., None]  # (B,F,9): [a0 b0 c0 a1 b1 c1 a2 b2 c2] / denom
    n0 = attributes[..., 0, :]
    n1 = attributes[..., 1, :]
    n2 = attributes[..., 2, :]
    PA = coeffs[..., 0:1] * n0 + coeffs[..., 3:4] * n1 + coeffs[..., 6:7] * n2
    PB = coeffs[..., 1:2] * n0 + coeffs[..., 4:5] * n1 + coeffs[..., 7:8] * n2
    PC = coeffs[..., 2:3] * n0 + coeffs[..., 5:6] * n1 + coeffs[..., 8:9] * n2
    return torch.cat([PA, PB, PC], dim=-1)


def normal_planes(face_verts: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """`attr_planes`' planes in the form K1's records carry: the slopes
    from the edges and normal steps out of corner 0, the constant from
    corner 0, PC = n0 - PA*x0 - PB*y0. The same plane as `attr_planes`,
    without its cancelling constants x_j*y_k - y_j*x_k: at a sliver face
    their rounding, divided by the tiny area, moved the shaded render by up
    to 1e-3 under a one-ulp change of the vertices, past the 1e-4 that
    batch 1 is held to against a batched call; here the coefficients stay
    within a few ulps of their float64 values. The training raster keeps
    `attr_planes`, the JAX package's form, which its render and gradient
    are held to. (B,F,3,3) verts + (B,F,3,D) -> (B,F,3D)."""
    x0, y0 = face_verts[..., 0, 0], face_verts[..., 0, 1]
    dx1, dy1 = face_verts[..., 1, 0] - x0, face_verts[..., 1, 1] - y0
    dx2, dy2 = face_verts[..., 2, 0] - x0, face_verts[..., 2, 1] - y0
    denom = dx1 * dy2 - dy1 * dx2
    inv = (1.0 / torch.where(denom.abs() >= AREA_EPS, denom, 1.0))[..., None]
    n0 = normals[..., 0, :]
    d1, d2 = normals[..., 1, :] - n0, normals[..., 2, :] - n0
    PA = (d1 * dy2[..., None] - d2 * dy1[..., None]) * inv
    PB = (d2 * dx1[..., None] - d1 * dx2[..., None]) * inv
    PC = n0 - PA * x0[..., None] - PB * y0[..., None]
    return torch.cat([PA, PB, PC], dim=-1)


def face_records_shaded(
    face_verts: torch.Tensor, face_normals: torch.Tensor
) -> torch.Tensor:
    """(B,F,3,3) verts + (B,F,3,3) corner normals -> (B,F,32) records.

    Lanes 0-12 as face_records (lane 12 = face id, set by the caller);
    lanes 16-24 hold the affine normal planes
    [NAx NAy NAz | NBx NBy NBz | NCx NCy NCz] (`normal_planes`).
    """
    base = face_records(face_verts)
    nplane = normal_planes(face_verts, face_normals)
    pad = face_verts.new_zeros(face_verts.shape[:-2] + (7,))
    return torch.cat([base, nplane, pad], dim=-1)


def _gather_recs(records: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """records (B,F,L), ids (B,N) int (-1 = empty) -> (B,N,L). Empty slots
    read a kill row (edge c0 = -1, fid = -1) appended at index F."""
    B, F, L = records.shape
    kill = records.new_zeros((L,))
    kill[2:3].fill_(-1.0)
    kill[12:13].fill_(-1.0)
    ext = torch.cat([records, kill.expand(B, 1, L)], dim=1)
    idx = torch.where(ids < 0, F, ids).long()
    b = torch.arange(B, device=records.device)[:, None]
    return ext[b, idx]


def _compact_windows(counts: torch.Tensor, cmax: int):
    """The compact layout's chunk windows: tile t's occupied chunks take
    positions [starts, ends) of one list per image, in tile order; those at
    or past cmax are dropped. counts (B,Tp) -> (starts, ends (B,Tp) int32
    clipped to cmax, dropped (B,) int32 occupied chunks past cmax)."""
    cc = (counts + (V3_CHUNK - 1)) // V3_CHUNK
    ends = torch.cumsum(cc, dim=1, dtype=torch.int32)
    dropped = (ends[:, -1] - cmax).clamp_min(0).to(torch.int32)
    return ((ends - cc).clamp(max=cmax).to(torch.int32),
            ends.clamp(max=cmax).to(torch.int32), dropped)


def _compact_plan(counts: torch.Tensor, cmax: int):
    """Chunk windows + chunk->tile map for the compact layout.

    counts (B,Tp) -> (starts, ends, tof, total, dropped): starts/ends
    (B,Tp) int32 chunk windows clipped to cmax (`_compact_windows`); tof
    (B,cmax) tile of each compact chunk; total (B,) int32 occupied chunks
    kept; dropped (B,) int32 occupied chunks beyond the budget. dropped > 0
    means trailing tiles were clipped to EMPTY windows; the renderer
    reports it as `raster_overflow`.
    """
    B, Tp = counts.shape
    starts, ends, dropped = _compact_windows(counts, cmax)
    c_ids = torch.arange(cmax, dtype=torch.int32, device=counts.device)
    # for c < cmax the clipped ends pass c exactly where the unclipped do
    tof = torch.searchsorted(ends, c_ids[None].expand(B, cmax).contiguous(),
                             right=True)
    tof = tof.clamp(max=Tp - 1).to(torch.int32)
    return starts, ends, tof, ends[:, -1].contiguous(), dropped


# ---------------------------------------------------------------------------
# K2's contract: chunk compaction (folded into K1's and K3's staging)
# ---------------------------------------------------------------------------


def compact_faces_plain(tof, starts, total, bins, cpt: int) -> torch.Tensor:
    """Plain statement of K2's contract (`_compact_faces_kernel`, which the
    TPU needs because its kernels cannot gather; K1 and K3 read the bins
    through instead). bins (B, Tp*cpt, 32) int32: tile t's chunk k is row
    t*cpt + k. -> (B, cmax, 32) int32: row c < total[b] is the chunk
    k = c - starts[b, tof[b, c]] of tile tof[b, c]; rows past total are -1."""
    B, cmax = tof.shape
    c = torch.arange(cmax, device=tof.device)[None]
    k = c - torch.gather(starts, 1, tof.long())
    src = (tof * cpt + k).clamp(0, bins.shape[1] - 1).long()
    rows = bins[torch.arange(B, device=bins.device)[:, None], src]
    return torch.where((c < total[:, None])[..., None], rows, -1)


def _check_cuda(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")


# ---------------------------------------------------------------------------
# K1: fused z-buffer + normal planes over each tile's kept chunks
# ---------------------------------------------------------------------------


def _tile_centers(Tp: int, image_size: int, tiles_x: int, device, local: bool = False):
    """(Tp, 1024) NDC x and y of every pixel of every tile, row-major in
    the 8x128 tile. local: every tile takes the centres of the image's
    first tile, ndc(p % 128) and ndc(p / 128) (tile-local records)."""
    pix = torch.arange(TILE_PIX, device=device)
    t = torch.arange(Tp, device=device)
    if local:
        t = torch.zeros_like(t)
    col = pix[None] % TILE_COLS + (t % tiles_x)[:, None] * TILE_COLS
    row = pix[None] // TILE_COLS + (t // tiles_x)[:, None] * TILE_ROWS
    return _ndc(col, image_size), _ndc(row, image_size)


def _affine(rec, ia, ib, ic, xs, ys):
    return rec[..., ia] * xs + rec[..., ib] * ys + rec[..., ic]


def _plain_zbuffer(starts, ends, recs, image_size: int, tiles_x: int, *,
                   local: bool = False, clist=None, chunk: int = V3_CHUNK):
    """The chunk walk shared by the plain versions of the window rasters.

    starts/ends (B,Tp) int32: tile t walks chunks [starts, ends) of its
    image's record list recs (B, N*chunk, L) f32; with clist (B,Tp,cap)
    int32 it walks the chunk ids clist[b, t, starts:ends] instead. Within
    a chunk the nearest inside face wins, first slot on ties; a later
    chunk replaces the winner only if strictly nearer. local: tile-local
    pixel centres (`_tile_centers`). Yields, per group of images (bounded
    so that no intermediate exceeds _PLAIN_BLOCK_ELEMS elements): (bidx
    (G,1) image ids, bz (G,Tp,P) nearest depth (1e10 empty), win (G,Tp,P)
    the winner's index in its image's record list, x, y (1,Tp,P) pixel
    centres).
    """
    B, Tp = starts.shape
    dev = recs.device
    CH, L = chunk, recs.shape[-1]
    chunks = recs.reshape(B, -1, CH, L)
    xs, ys = _tile_centers(Tp, image_size, tiles_x, dev, local)
    xs, ys = xs[None, :, None, :], ys[None, :, None, :]  # (1,Tp,1,P)
    slot = torch.arange(CH, device=dev)[None, None, :, None]
    group = max(1, _PLAIN_BLOCK_ELEMS // (Tp * CH * TILE_PIX))
    for b0 in range(0, B, group):
        s, e = starts[b0:b0 + group].long(), ends[b0:b0 + group].long()
        G = s.shape[0]
        bidx = torch.arange(b0, b0 + G, device=dev)[:, None]
        bz = torch.full((G, Tp, 1, TILE_PIX), BIG_Z, device=dev)
        win = torch.zeros((G, Tp, 1, TILE_PIX), dtype=torch.long, device=dev)
        n_steps = int((e - s).max()) if G else 0
        for j in range(max(n_steps, 0)):
            active = s + j < e
            c = torch.where(active, s + j, 0)
            if clist is not None:
                c = torch.gather(clist[b0:b0 + G].long(), 2, c[..., None])[..., 0]
            rec = chunks[bidx, c]  # (G,Tp,CH,L)
            rec = rec[..., None, :]  # (G,Tp,CH,1,L)
            e0 = _affine(rec, 0, 1, 2, xs, ys)
            e1 = _affine(rec, 3, 4, 5, xs, ys)
            e2 = _affine(rec, 6, 7, 8, xs, ys)
            z = _affine(rec, 9, 10, 11, xs, ys)
            inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (rec[..., 12] >= 0)
                      & active[:, :, None, None])
            zm = torch.where(inside, z, BIG_Z)
            cz = zm.amin(dim=2, keepdim=True)
            best = torch.where(zm == cz, slot, CH).amin(dim=2, keepdim=True)
            better = cz < bz
            bz = torch.where(better, cz, bz)
            win = torch.where(better, c[:, :, None, None] * CH + best, win)
        yield bidx, bz[:, :, 0], win[:, :, 0], xs[:, :, 0], ys[:, :, 0]


def _fused_plain(starts, ends, recs, image_size: int, tiles_x: int, **walk):
    """`_plain_zbuffer` over records in the RECF_LANES layout + the
    winner's normal planes. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf (1e10
    empty), nx, ny, nz (0 empty), all f32 but p2f."""
    outs = []
    for bidx, bz, win, x, y in _plain_zbuffer(starts, ends, recs, image_size,
                                              tiles_x, **walk):
        covered = bz < BIG_Z
        wrec = recs[bidx[:, :, None], win]  # (G,Tp,P,L)
        planes = [_affine(wrec, 16 + d, 19 + d, 22 + d, x, y) for d in range(3)]
        outs.append((
            torch.where(covered, wrec[..., 12].to(torch.int32), -1),
            torch.where(covered, bz, BIG_Z),
            *[torch.where(covered, n, 0.0) for n in planes],
        ))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _bin_walk(kept, bins, records):
    """The plain versions' form of the read-through inputs: each tile's bin
    of records gathered (empty slots a kill row), tile t walking chunks
    [t*cpt, t*cpt + kept) of it, kept clamped to [0, cpt] as the kernels
    clamp it (cpt = C/32). kept (B,Tp) int32, bins (B,Tp,C) int32, records
    (B,F,L) -> (starts, ends (B,Tp), recs (B, Tp*C, L)). A 2-D `bins` is
    the old chunk-window form (starts, ends, recs) of these arguments and
    raises ValueError, so that a call in that form is not misread."""
    if bins.ndim != 3 or kept.ndim != 2:
        raise ValueError(f"expected kept (B,Tp) and bins (B,Tp,C), got kept "
                         f"{tuple(kept.shape)} and bins {tuple(bins.shape)}; the "
                         "(starts, ends, recs) window form is not taken")
    B, Tp, C = bins.shape
    cpt = C // V3_CHUNK
    starts = (torch.arange(Tp, dtype=torch.int32, device=bins.device) * cpt)[None].expand(B, Tp)
    return (starts, starts + kept.clamp(0, cpt),
            _gather_recs(records, bins.reshape(B, Tp * C)))


def raster_fused_windows_plain(kept, bins, records, image_size: int, tiles_x: int):
    """Plain version of K1: `_fused_plain` over chunks 0 .. kept - 1 of each
    tile's gathered bin (`_bin_walk`). -> p2f (B,Tp,1024) int32 (-1
    empty), zbuf (1e10 empty), nx, ny, nz (0 empty), all f32 but p2f.
    """
    return _fused_plain(*_bin_walk(kept, bins, records), image_size, tiles_x)


def _fused_outputs(B: int, Tp: int, dev):
    """Empty (p2f int32, zbuf, nx, ny, nz f32), each (B,Tp,1024)."""
    return (torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev),
            *(torch.empty((B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
              for _ in range(4)))


def _check_read_through(name, kept, bins, records, face_verts, lanes: int):
    """Check the read-through rasters' inputs on the card (face_verts: the
    faces the records were built from, which the kernels cull with),
    without reading them -> (B, Tp, C, F)."""
    dev = records.device
    _check_cuda("kept", kept, torch.int32, 2, dev)
    _check_cuda("bins", bins, torch.int32, 3, dev)
    _check_cuda("records", records, torch.float32, 3, dev)
    _check_cuda("face_verts", face_verts, torch.float32, 4, dev)
    B, Tp, C = bins.shape
    if (tuple(kept.shape) != (B, Tp) or C % V3_CHUNK or records.shape[0] != B
            or records.shape[2] != lanes
            or tuple(face_verts.shape) != (B, records.shape[1], 3, 3)):
        raise ValueError(f"{name}: inconsistent shapes kept {tuple(kept.shape)} "
                         f"bins {tuple(bins.shape)} records {tuple(records.shape)} "
                         f"({lanes} lanes) face_verts {tuple(face_verts.shape)}")
    if records.data_ptr() % 16:
        raise ValueError(f"{name}: records must be 16-byte aligned")
    return B, Tp, C, records.shape[1]


def raster_fused_windows(kept, bins, records, face_verts, image_size: int,
                         tiles_x: int):
    """K1: per-tile z-buffer over chunks 0 .. kept - 1 of the tile's bin +
    the winner's normals. kept (B,Tp) int32 (`_windows`), bins (B,Tp,C)
    int32 as `bin_faces_flat` gives them, records (B,F,32) f32 as
    `fused_records` gives them, face_verts (B,F,3,3) f32 (the faces the
    records were built from; the kernel culls with them) -> as
    `raster_fused_windows_plain`.

    Replaces `_raster_kernel_v7` (compact record list, packed by
    `_compact_faces_kernel`) and `_raster_kernel_v4` (padded layout)
    (smirk_tpu/render/rasterizer.py): the layouts differ only in kept.
    Bound on H100: fp32 operations (~16 per face-pixel test), with FMAs
    forbidden so that it stays bitwise equal to the plain version. Design:
    K3's (`raster_planes_windows`; the two share their walk): the records
    read through the bins and staged one chunk ahead with each face's cull
    box (`cull_boxes`) computed from its vertices; each of a block's 8
    warps owns a 16x8 pixel rectangle of the tile and skips a face whose
    box widened by one pixel misses it, so the number of face-pixel tests,
    not their cost, falls. The winner's normal planes are evaluated once,
    at the end. A kept count is clamped to [0, C/32], in the kernel and in
    the plain version. CPU tensors take the plain version, which tests
    every face.

    The call goes through the custom op `K1_OP`, so that `torch.export`
    traces a program that holds K1 (`smirk_tpu_torch.serving`); a loaded
    artifact runs the op, and its launches count all the same.
    """
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster_fused_windows: unsupported device {records.device}")
    return _k1_op(kept, bins, records, face_verts, int(image_size), int(tiles_x))


raster_fused_windows.launches = 0

# K1 as a custom op: the CPU implementation is the plain version, the CUDA
# one checks, launches and counts, the fake one gives the five outputs'
# shapes for a trace. No other device has an implementation. The outputs
# are fresh tensors (no output aliases an input).
K1_OP = "smirk_tpu_torch::raster_fused_windows"


@torch.library.custom_op(
    K1_OP, mutates_args=(), device_types="cpu",
    schema="(Tensor kept, Tensor bins, Tensor records, Tensor face_verts, "
           "int image_size, int tiles_x) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _k1_op(kept, bins, records, face_verts, image_size, tiles_x):
    return raster_fused_windows_plain(kept, bins, records, image_size, tiles_x)


@_k1_op.register_kernel("cuda")
def _k1_cuda(kept, bins, records, face_verts, image_size, tiles_x):
    dev = records.device
    B, Tp, C, F = _check_read_through("raster_fused_windows", kept, bins, records,
                                      face_verts, RECF_LANES)
    p2f, zbuf, nx, ny, nz = _fused_outputs(B, Tp, dev)
    lib = kernels.library("raster_fused")
    rc = lib.smirk_raster_fused_windows(
        kept.data_ptr(), bins.data_ptr(), records.data_ptr(), face_verts.data_ptr(),
        p2f.data_ptr(), zbuf.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
        B, Tp, C, F, image_size, image_size, tiles_x, _cull_grid_radius(image_size),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_fused_windows")
    raster_fused_windows.launches += 1
    return p2f, zbuf, nx, ny, nz


@_k1_op.register_fake
def _k1_fake(kept, bins, records, face_verts, image_size, tiles_x):
    return _fused_outputs(bins.shape[0], bins.shape[1], records.device)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def coverage_records(face_verts: torch.Tensor) -> torch.Tensor:
    """face_records with lane 12 set to the face id -> (B,F,16), K6's
    records."""
    records = face_records(face_verts)
    records[..., 12] = torch.arange(face_verts.shape[1], dtype=records.dtype,
                                    device=records.device)
    return records


def fused_records(face_verts: torch.Tensor, face_normals: torch.Tensor) -> torch.Tensor:
    """face_records_shaded with lane 12 set to the face id -> (B,F,32)."""
    records = face_records_shaded(face_verts, face_normals)
    records[..., 12] = torch.arange(face_verts.shape[1], dtype=records.dtype,
                                    device=records.device)
    return records


def padded_windows(counts: torch.Tensor, cpt: int):
    """Chunk windows of the padded layout, where tile t's bin occupies
    chunks [t*cpt, (t+1)*cpt) of the image's record list: (starts, ends)
    (B,Tp) int32 with ends = starts + ceil(count / 32)."""
    B, Tp = counts.shape
    tile0 = torch.arange(Tp, dtype=torch.int32, device=counts.device)[None] * cpt
    starts = tile0.expand(B, Tp).contiguous()
    return starts, starts + (counts + (V3_CHUNK - 1)) // V3_CHUNK


def _check_capacity(capacity: int) -> None:
    if capacity % V3_CHUNK:
        raise ValueError(f"capacity {capacity} is not a multiple of {V3_CHUNK}")


def _windows(counts: torch.Tensor, compact: Optional[int]):
    """How many chunks of its bin each tile walks -> (kept (B,Tp) int32,
    overflow (B,) int32). compact: chunk budget of the compact layout
    (rounded up to 8): a tile keeps its window of the plan clipped to the
    budget (`_compact_windows`), and overflow counts the occupied chunks
    dropped past it. None = the padded layout: ceil(count / 32), overflow
    0."""
    if compact is None:
        return ((counts + (V3_CHUNK - 1)) // V3_CHUNK,
                torch.zeros((counts.shape[0],), dtype=torch.int32, device=counts.device))
    starts, ends, dropped = _compact_windows(counts, -(-compact // 8) * 8)
    return ends - starts, dropped


def packed_layout_plain(records, bins, counts, compact: int):
    """The compact layout as the TPU builds it, for checks: `_compact_plan`,
    K2's contract (`compact_faces_plain`) and a gather of the packed
    chunks' records (empty slots a kill row) -> (starts, ends (B,Tp)
    int32, recs (B, cmax*32, L), overflow (B,) int32), cmax the budget
    rounded up to 8. `_fused_plain` / `_planes_plain` over these windows
    equal K1 / K3 over `_windows(counts, compact)`, bins and records,
    bitwise."""
    B, Tp, C = bins.shape
    cpt = C // V3_CHUNK
    starts, ends, tof, total, overflow = _compact_plan(counts, -(-compact // 8) * 8)
    faces = compact_faces_plain(tof, starts, total, bins.reshape(B, Tp * cpt, V3_CHUNK),
                                cpt)
    return starts, ends, _gather_recs(records, faces.reshape(B, -1)), overflow


# ---------------------------------------------------------------------------
# K9 / K10: the merged loop over groups of tiles
# ---------------------------------------------------------------------------


# Tiles per group of the merged rasters when the caller gives none: the JAX
# package's `_pick_tps` at its defaults (its TPU sweep found 8, 16 and 24
# equal and capped the choice at 8).
MERGED_TPS = 8


def _pad_tiles_to(bins, counts, tps: int):
    """Pad the tile axis of bins (B,Tp,C) and counts (B,Tp) with empty tiles
    to a multiple of `tps`."""
    B, Tp, C = bins.shape
    Tq = -(-Tp // tps) * tps
    if Tq != Tp:
        bins = torch.cat([bins, bins.new_full((B, Tq - Tp, C), -1)], dim=1)
        counts = torch.cat([counts, counts.new_zeros((B, Tq - Tp))], dim=1)
    return bins, counts


def group_windows(counts: torch.Tensor, cpt: int, tps: int):
    """Chunk windows of the merged schedule on the padded layout: tile t
    walks chunks [t*cpt, t*cpt + n) where n = ceil(max count of its group
    of `tps` tiles / 32); its chunks past its own count hold kill records.
    counts (B,Tp), Tp a multiple of tps -> (starts, ends) (B,Tp) int32."""
    B, Tp = counts.shape
    gmax = counts.reshape(B, Tp // tps, tps).amax(-1, keepdim=True)
    n = ((gmax + (V3_CHUNK - 1)) // V3_CHUNK).expand(B, Tp // tps, tps).reshape(B, Tp)
    starts, _ = padded_windows(counts, cpt)
    return starts, (starts + n).to(torch.int32)


def raster_fused_groups_plain(counts, bins, records, *, image_size: int, tiles_x: int,
                              tps: int):
    """Plain version of K9, the merged schedule: every tile of a group of
    `tps` walks chunk k = 0 .. ceil(group max count / 32) - 1 of its padded
    bin (`group_windows`, counts clamped to [0, C]), its chunks past its own
    count kill records, then `_fused_plain`. counts (B,Tp) int32, Tp a
    multiple of tps; bins (B,Tp,C) int32; records (B,F,32) f32 ->
    as `raster_fused_windows_plain`."""
    B, Tp, C = bins.shape
    starts, ends = group_windows(counts.clamp(0, C), C // V3_CHUNK, tps)
    return _fused_plain(starts, ends, _gather_recs(records, bins.reshape(B, Tp * C)),
                        image_size, tiles_x)


def raster_fused_groups(counts, bins, records, face_verts, *, image_size: int,
                        tiles_x: int, tps: int):
    """K9: the merged schedule's z-buffer + the winner's normals on the
    padded layout. counts (B,Tp) int32 (Tp a multiple of tps), bins (B,Tp,C)
    int32, records (B,F,32) f32 (`fused_records`), face_verts (B,F,3,3) f32
    (the faces the records were built from; the kernel culls with them) ->
    as `raster_fused_groups_plain`, bitwise equal to K1 on the padded
    windows. The arguments after face_verts are keyword-only, so that the
    old call (counts, recs, image_size, tiles_x, tps) raises.

    Replaces `_raster_kernel_v6` (smirk_tpu/render/rasterizer.py). Bound on
    H100: K1b's, the same function on the same faces. Design: K1's walk
    (csrc/window_raster.cuh), one block per (tile, image), the records read
    through the bins and staged one chunk ahead with each face's cull box,
    each tile walking its own ceil(count / 32) chunks: the group's further
    chunks, which the TPU schedule walks, hold kill records only. CPU
    tensors take the plain version, which walks them and tests every face.
    """
    if records.device.type == "cpu":
        return raster_fused_groups_plain(counts, bins, records, image_size=image_size,
                                         tiles_x=tiles_x, tps=tps)
    if records.device.type != "cuda":
        raise ValueError(f"raster_fused_groups: unsupported device {records.device}")
    outs = _launch_groups("raster_fused_groups", counts, bins, None, records, face_verts,
                          image_size, tiles_x, tps)
    raster_fused_groups.launches += 1
    return outs


raster_fused_groups.launches = 0


def _launch_groups(name, counts, bins, order, records, face_verts, image_size: int,
                   tiles_x: int, tps: int):
    """Check the inputs of K9 (order None) or K10 on the card and launch ->
    (p2f, zbuf, nx, ny, nz) (B,Tp,1024)."""
    dev = records.device
    B, Tp, C, F = _check_read_through(name, counts, bins, records, face_verts, RECF_LANES)
    if tps < 1 or Tp % tps:
        raise ValueError(f"{name}: {Tp} tiles are not a multiple of tps {tps}")
    if order is not None:
        _check_cuda("order", order, torch.int32, 2, dev)
        if tuple(order.shape) != (B, Tp):
            raise ValueError(f"{name}: order {tuple(order.shape)} is not {(B, Tp)}")
    outs = _fused_outputs(B, Tp, dev)
    rc = kernels.library("raster_groups").smirk_raster_fused_groups(
        counts.data_ptr(), bins.data_ptr(), None if order is None else order.data_ptr(),
        records.data_ptr(), face_verts.data_ptr(), *(o.data_ptr() for o in outs),
        B, Tp, C, F, image_size, image_size, tiles_x, int(order is not None),
        _cull_grid_radius(image_size), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, name)
    return outs


def raster_fused_groups_local_plain(counts, bins, order, records, *, image_size: int,
                                    tiles_x: int, tps: int):
    """Plain version of K10: the merged schedule (`group_windows`, counts
    clamped to [0, C]) over count-sorted tiles whose bins' records are
    rebased to tile-local coordinates (`_tilelocal_adjust`, row t at tile
    order[t]), at the first tile's pixel centres. counts (B,Tp) int32 and
    bins (B,Tp,C) int32 in the sorted order, order (B,Tp) int32, records
    (B,F,32) f32 -> as `raster_fused_windows_plain`, in the sorted order."""
    B, Tp, C = bins.shape
    recs = _gather_recs(records, bins.reshape(B, Tp * C)).reshape(B, Tp, C, RECF_LANES)
    recs = _tilelocal_adjust(recs, order, image_size, tiles_x)
    starts, ends = group_windows(counts.clamp(0, C), C // V3_CHUNK, tps)
    return _fused_plain(starts, ends, recs.reshape(B, Tp * C, RECF_LANES), image_size,
                        tiles_x, local=True)


def raster_fused_groups_local(counts, bins, order, records, face_verts, *,
                              image_size: int, tiles_x: int, tps: int):
    """K10: K9 over count-sorted tiles (`sort_tiles_order`), each evaluated
    on its records rebased to tile-local coordinates at the pixel centres
    of the image's first tile. counts (B,Tp) int32, bins (B,Tp,C) int32,
    both in the sorted order; order (B,Tp) int32 (row t is tile order[t]
    of the image); records (B,F,32) f32; face_verts (B,F,3,3) f32 -> as
    `raster_fused_groups_local_plain`, in the sorted order. The arguments
    after face_verts are keyword-only; the old call (counts, recs,
    image_size, tps) raises.

    Replaces `_raster_kernel_v6tl` (smirk_tpu/render/rasterizer.py). Bound:
    K9's. Design: K9's source with the tile-local flag; the kernel rebases
    each staged record, and the winner's normal planes, with
    `_tilelocal_adjust`'s arithmetic, so no rebased copy of the records is
    built; its cull boxes take the rebase's margin (`cull_boxes_local`) and
    the warp rectangles the tile's real position. CPU tensors take the
    plain version.
    """
    if records.device.type == "cpu":
        return raster_fused_groups_local_plain(counts, bins, order, records,
                                               image_size=image_size, tiles_x=tiles_x,
                                               tps=tps)
    if records.device.type != "cuda":
        raise ValueError(f"raster_fused_groups_local: unsupported device {records.device}")
    outs = _launch_groups("raster_fused_groups_local", counts, bins, order, records,
                          face_verts, image_size, tiles_x, tps)
    raster_fused_groups_local.launches += 1
    return outs


raster_fused_groups_local.launches = 0

# RECF record lanes of the affine forms [3 edges | zplane | 9 normal-plane
# components]: x-coefficients (a), y-coefficients (b) and constants (c)
_RECF_A = (0, 3, 6, 9, 16, 17, 18)
_RECF_B = (1, 4, 7, 10, 19, 20, 21)
_RECF_C = (2, 5, 8, 11, 22, 23, 24)


def _tilelocal_adjust(recs, tids, image_size: int, tx_tiles: int):
    """Rebase records into tile-local pixel coordinates: every affine form
    a*x + b*y + c becomes a*xl + b*yl + c' with c' = c + (a*dx + b*dy),
    (dx, dy) = (2*tx*128/W, 2*ty*8/H) the NDC offset of tile t's origin.
    Every product and sum is rounded on its own (no fused multiply-add),
    and the divisor is a tensor (`_ndc`'s note), so that the card and the
    CPU rebase alike. recs (B,Tp,C,32), tids (B,Tp) the tiles' positions ->
    (B,Tp,C,32)."""
    tyv = (tids // tx_tiles).to(recs.dtype)
    txv = (tids % tx_tiles).to(recs.dtype)
    size = torch.full_like(txv, float(image_size))
    dx = (2.0 * txv * TILE_COLS / size)[:, :, None, None]  # (B,Tp,1,1)
    dy = (2.0 * tyv * TILE_ROWS / size)[:, :, None, None]
    ia, ib, ic = (list(g) for g in (_RECF_A, _RECF_B, _RECF_C))
    out = recs.clone()
    out[..., ic] = recs[..., ic] + (recs[..., ia] * dx + recs[..., ib] * dy)
    return out


def sort_tiles_order(bins, counts):
    """K10's tile order: the tiles by descending count (stable), so that
    each group of tps tiles is count-homogeneous and padding tiles (count
    0) come last. bins (B,Tp,C), counts (B,Tp) -> (sorted counts (B,Tp)
    int32, sorted bins (B,Tp,C) int32, order (B,Tp) int32: row t is tile
    order[t], inverse order (B,Tp): output row inv[b, t] of the sorted
    raster is tile t)."""
    order = torch.argsort(-counts, dim=1, stable=True)
    return (torch.gather(counts, 1, order),
            torch.gather(bins, 1, order[..., None].expand_as(bins)).contiguous(),
            order.to(torch.int32), torch.argsort(order, dim=1))


def sorted_tiles(records, bins, counts, image_size: int):
    """The packed route to K10's function, as the TPU takes it, for checks:
    `sort_tiles_order`, then the sorted bins' records gathered and rebased
    to tile-local coordinates. records (B,F,32), bins (B,Tp,C), counts
    (B,Tp) -> (sorted counts (B,Tp) int32, recs (B, Tp*C, 32) contiguous,
    inverse order (B,Tp)); `_fused_plain(*group_windows(...), recs,
    local=True)` over them equals K10 over the read-through inputs."""
    B, Tp, C = bins.shape
    counts, bins, order, inv = sort_tiles_order(bins, counts)
    recs = _gather_recs(records, bins.reshape(B, Tp * C)).reshape(B, Tp, C, RECF_LANES)
    recs = _tilelocal_adjust(recs, order, image_size, -(-image_size // TILE_COLS))
    return counts, recs.reshape(B, Tp * C, RECF_LANES).contiguous(), inv


# ---------------------------------------------------------------------------
# Fused inference raster
# ---------------------------------------------------------------------------


def rasterize_normals_fused(
    face_verts: torch.Tensor,
    face_normals: torch.Tensor,
    image_size: int,
    capacity: int = 640,
    *,
    merged: bool = False,
    tps: Optional[int] = None,
    sort_tiles: bool = False,
    compact: Optional[int] = None,
    bin_approx: Optional[float] = None,
    return_overflow: bool = False,
    bin_miss_check: bool = False,
):
    """Fused inference raster -> (normal image (B,H,W,3), pix_to_face
    (B,H,W) int32, zbuf (B,H,W)[, overflow (B,) int32]).

    Binning goes through the dispatch (`bin_faces`, the `set_bin_mode`
    mode) with `bin_approx` as its recall target. bin_miss_check adds the
    binning's `selection_misses` to overflow, its only output surface, so
    it needs return_overflow (ValueError otherwise).

    compact: chunk budget of the compact layout (rounded up to 8; K1);
    None = the padded layout, where each tile walks its own bin: K1 on its
    own window, or with `merged` K9 (the merged schedule, whose contract
    walks every tile of a group of `tps` to the group's maximum), or with
    `sort_tiles` K10 (tiles count-sorted, tile-local records, outputs
    un-permuted); K9 and K10 read the records through the bins. compact
    wins over merged; sort_tiles with compact raises ValueError. tps
    (default `MERGED_TPS`, 8) pads the tile axis of the merged and sorted
    rasters to a multiple; the other layouts ignore it. overflow counts
    compact chunks dropped past the budget (0 on the padded layout).
    """
    _check_capacity(capacity)
    if bin_miss_check and not return_overflow:
        raise ValueError(
            "bin_miss_check computes selection misses that surface only through "
            "the overflow output; pass return_overflow=True")
    if sort_tiles and compact is not None:
        raise ValueError(
            "sort_tiles is incompatible with compact: the compact raster derives "
            "each tile's pixel coordinates from its row index, so sorted bins "
            "would be tested against the wrong pixels")
    binned = bin_faces(face_verts, image_size, capacity, bin_approx,
                       with_misses=bin_miss_check)
    bins, counts = binned[:2]
    tx = -(-image_size // TILE_COLS)
    records = fused_records(face_verts, face_normals)
    tps = MERGED_TPS if tps is None else tps
    face_verts = face_verts.contiguous()
    if sort_tiles:
        counts, bins, order, inv_order = sort_tiles_order(*_pad_tiles_to(bins, counts, tps))
        outs = raster_fused_groups_local(counts, bins, order, records, face_verts,
                                         image_size=image_size, tiles_x=tx, tps=tps)
        outs = [torch.gather(o, 1, inv_order[..., None].expand_as(o)) for o in outs]
        overflow = torch.zeros((counts.shape[0],), dtype=torch.int32, device=counts.device)
    elif merged and compact is None:
        bins, counts = _pad_tiles_to(bins, counts, tps)
        outs = raster_fused_groups(counts, bins, records, face_verts,
                                   image_size=image_size, tiles_x=tx, tps=tps)
        overflow = torch.zeros((counts.shape[0],), dtype=torch.int32, device=counts.device)
    else:
        kept, overflow = _windows(counts, compact)
        outs = raster_fused_windows(kept, bins, records, face_verts, image_size, tx)
    p2f = _tiles_to_image(outs[0], image_size)
    zbuf = _tiles_to_image(outs[1], image_size)
    normals = torch.stack([_tiles_to_image(o, image_size) for o in outs[2:5]], dim=-1)
    if return_overflow:
        if bin_miss_check:
            overflow = overflow + binned[2]
        return normals, p2f, zbuf, overflow
    return normals, p2f, zbuf


# ---------------------------------------------------------------------------
# K11: the chunk-skip raster
#
# Bins fixed CH-face chunks of a spatially ordered face list instead of
# faces: the per-tile top-k is over NC = F/CH keys, and the kernel reads
# each binned chunk from the image's full record table, so there is no
# record gather and no compact plan. The price is records: every face of
# a binned chunk is staged even if one member overlaps the tile (the
# kernel's warp cull keeps the tests of the others from costing more).
# ---------------------------------------------------------------------------


def spatial_face_order(vertices, faces, bits: int = 10):
    """Static Morton (z-order) permutation of faces by template centroid
    (numpy, host side, once per mesh), so that consecutive faces are close
    on screen: x and y dominate, z is scaled by 0.01. -> (F,) int64
    permutation."""
    cent = np.asarray(vertices)[np.asarray(faces)].mean(1)
    cent = cent - cent.min(0)
    cent[:, 2] *= 0.01  # screen-space locality dominates
    q = np.clip(cent / (cent.max(0) + 1e-9) * (2 ** bits - 1),
                0, 2 ** bits - 1).astype(np.uint64)
    key = np.zeros(len(cent), np.uint64)
    for b in range(bits):
        for d in range(3):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    return np.argsort(key, kind="stable")


def _pad_faces_offscreen(face_verts: torch.Tensor, chunk: int):
    """Pad F to a multiple of `chunk` with faces at NDC 4.0 (pixel ~2.5 W):
    their bboxes miss every tile, so they bin nowhere. -> (face_verts, pad)."""
    B, F = face_verts.shape[:2]
    pad = (-F) % chunk
    if pad:
        far = face_verts.new_full((B, pad, 3, 3), 4.0)
        face_verts = torch.cat([face_verts, far], dim=1)
    return face_verts, pad


def bin_chunks(face_verts: torch.Tensor, image_size: int, chunk: int, cap: int):
    """Assign fixed `chunk`-face chunks to pixel tiles by any-member bbox
    overlap (after the backface cull).

    face_verts (B,F,3,3), F a multiple of chunk -> (clist (B,Tp,cap) int32
    chunk ids, near-to-far, 0 past each count; counts (B,Tp) int32;
    dropped (B,) int32 overlapping chunks past `cap`, summed over tiles).
    An exact top-k over NC = F/chunk keys with chunk priority the least
    priority of its members; the keys are unique, so the order is the JAX
    package's."""
    B, F = face_verts.shape[:2]
    if F % chunk:
        raise ValueError(f"{F} faces are not a multiple of the chunk {chunk}: "
                         "pad them first (_pad_faces_offscreen)")
    NC = F // chunk
    overlap, prio, prio_span = _tile_overlap(face_verts, image_size)
    T = overlap.shape[1]
    occ = overlap.reshape(B, T, NC, chunk).any(-1)  # (B,T,NC)
    cprio = prio.reshape(B, NC, chunk).amin(-1)  # (B,NC) near-to-far
    k = min(cap, NC)
    key = occ.to(torch.int32) * (prio_span + 1) - cprio[:, None, :]
    vals, idx = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    valid = vals > 0
    clist = torch.where(valid, idx.to(torch.int32), 0)
    counts = valid.sum(-1, dtype=torch.int32)
    dropped = (occ.sum(-1) - k).clamp_min(0).sum(-1).to(torch.int32)
    if k < cap:
        clist = torch.cat([clist, clist.new_zeros((B, T, cap - k))], dim=-1)
    Tp = -(-T // 8) * 8
    if Tp != T:
        clist = torch.cat([clist, clist.new_zeros((B, Tp - T, cap))], dim=1)
        counts = torch.cat([counts, counts.new_zeros((B, Tp - T))], dim=1)
    return clist, counts, dropped


CHUNKSKIP_CHUNKS = (4, 8, 16, 32)  # the chunk sizes K11 takes


def raster_chunkskip_plain(counts, clist, recs, *, image_size: int, tiles_x: int,
                           chunk: int):
    """Plain version of K11: tile t walks the chunk ids clist[b, t,
    :counts[b, t]] in order (counts clamped to [0, cap]), each the `chunk`
    consecutive records at row cid*chunk of its image's table recs
    (B,F,32), testing every face; `_fused_plain`'s rule and outputs. -> as
    `raster_fused_windows_plain`."""
    counts = counts.clamp(0, clist.shape[2])
    return _fused_plain(torch.zeros_like(counts), counts, recs, image_size, tiles_x,
                        clist=clist, chunk=chunk)


def raster_chunkskip(counts, clist, recs, face_verts, *, image_size: int, tiles_x: int,
                     chunk: int):
    """K11: per-tile z-buffer over a list of chunk ids into the image's full
    record table + the winner's normals; counts (B,Tp) int32, clist
    (B,Tp,cap) int32, recs (B,F,32) f32 with F a multiple of chunk,
    face_verts (B,F,3,3) f32 (the padded faces the records were built from;
    the kernel culls with them) -> as `raster_chunkskip_plain`. The
    arguments after face_verts are keyword-only, so that the old call
    (counts, clist, recs, image_size, tiles_x, chunk) raises.

    Replaces `_raster_kernel_v8` (smirk_tpu/render/rasterizer.py). Bound on
    H100: K1's function on the same faces, with the records of every binned
    chunk read once. Design: K1's walk (csrc/window_raster.cuh), one block
    per (tile, image), over the tile's chunk-id list, 32 faces (32 / chunk
    list entries) a step, each record read from the full table and staged
    one step ahead with its face's cull box (`cull_boxes`; the padding
    faces, id -1, an empty one), each warp testing only the faces whose box
    meets its 16x8 rectangle, in list-then-slot order. CPU tensors take the
    plain version, which tests every face.
    """
    if recs.device.type == "cpu":
        return raster_chunkskip_plain(counts, clist, recs, image_size=image_size,
                                      tiles_x=tiles_x, chunk=chunk)
    if recs.device.type != "cuda":
        raise ValueError(f"raster_chunkskip: unsupported device {recs.device}")
    dev = recs.device
    _check_cuda("counts", counts, torch.int32, 2, dev)
    _check_cuda("clist", clist, torch.int32, 3, dev)
    _check_cuda("recs", recs, torch.float32, 3, dev)
    _check_cuda("face_verts", face_verts, torch.float32, 4, dev)
    B, Tp = counts.shape
    F = recs.shape[1]
    if (chunk not in CHUNKSKIP_CHUNKS or tuple(clist.shape[:2]) != (B, Tp)
            or recs.shape[0] != B or recs.shape[2] != RECF_LANES or F % chunk
            or tuple(face_verts.shape) != (B, F, 3, 3)):
        raise ValueError("raster_chunkskip: inconsistent shapes "
                         f"counts {tuple(counts.shape)} clist {tuple(clist.shape)} "
                         f"recs {tuple(recs.shape)} face_verts {tuple(face_verts.shape)} "
                         f"chunk {chunk} (one of {CHUNKSKIP_CHUNKS})")
    if recs.data_ptr() % 16:
        raise ValueError("raster_chunkskip: recs must be 16-byte aligned")
    outs = _fused_outputs(B, Tp, dev)
    rc = kernels.library("raster_chunkskip").smirk_raster_chunkskip(
        counts.data_ptr(), clist.data_ptr(), recs.data_ptr(), face_verts.data_ptr(),
        *(o.data_ptr() for o in outs), B, Tp, clist.shape[2], F, chunk, image_size,
        image_size, tiles_x, _cull_grid_radius(image_size), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_chunkskip")
    raster_chunkskip.launches += 1
    return outs


raster_chunkskip.launches = 0


def chunkskip_inputs(face_verts, face_normals, image_size: int, chunk: int, cap: int,
                     face_ids=None):
    """K11's inputs: F padded to a multiple of `chunk` with off-screen faces
    of id -1 (zero normals), the records with lane 12 the face ids
    (default the face index), and `bin_chunks`. -> (counts (B,Tp), clist
    (B,Tp,cap), records (B,F_pad,32) contiguous, face_verts (B,F_pad,3,3)
    contiguous, the padded faces K11 culls with, dropped (B,))."""
    B, F0 = face_verts.shape[:2]
    fv, pad = _pad_faces_offscreen(face_verts, chunk)
    fn = face_normals
    if pad:
        fn = torch.cat([fn, fn.new_zeros((B, pad, 3, 3))], dim=1)
    if face_ids is None:
        ids = torch.arange(F0, dtype=fv.dtype, device=fv.device)
    else:
        ids = torch.as_tensor(face_ids, device=fv.device).to(fv.dtype)
    records = face_records_shaded(fv, fn)
    records[..., 12] = torch.cat([ids, ids.new_full((pad,), -1.0)])[None]
    clist, counts, dropped = bin_chunks(fv, image_size, chunk, cap)
    return counts, clist, records.contiguous(), fv.contiguous(), dropped


def rasterize_normals_chunkskip(
    face_verts: torch.Tensor,
    face_normals: torch.Tensor,
    image_size: int,
    chunk: int = 8,
    cap: int = 128,
    *,
    return_overflow: bool = False,
    face_ids: Optional[torch.Tensor] = None,
):
    """Chunk-skip fused inference raster -> (normals (B,H,W,3), pix_to_face
    (B,H,W) int32, zbuf (B,H,W)[, dropped (B,) int32]), the output contract
    of `rasterize_normals_fused`: `bin_chunks`, then K11 over the full
    record table. F is padded to a multiple of `chunk` with off-screen
    faces of id -1. face_ids (F,) are the ids written to pix_to_face (the
    original ids of a `spatial_face_order`-permuted input); default the
    face index. dropped counts overlapping chunks past `cap`. Ties between
    chunks go to the nearer chunk, so they may resolve to another (equally
    near) face than the face-binned rasters."""
    counts, clist, records, fv, dropped = chunkskip_inputs(
        face_verts, face_normals, image_size, chunk, cap, face_ids)
    outs = raster_chunkskip(counts, clist, records, fv, image_size=image_size,
                            tiles_x=-(-image_size // TILE_COLS), chunk=chunk)
    p2f = _tiles_to_image(outs[0], image_size)
    zbuf = _tiles_to_image(outs[1], image_size)
    normals = torch.stack([_tiles_to_image(o, image_size) for o in outs[2:5]], dim=-1)
    if return_overflow:
        return normals, p2f, zbuf, dropped
    return normals, p2f, zbuf


# ---------------------------------------------------------------------------
# The differentiable raster (training): K3 forward, K4's fold backward
# ---------------------------------------------------------------------------

REC5_LANES = 32  # [9 edge | 3 zplane | fid | PA(D) PB(D) PC(D) | pad], D <= 6
_REC5_PLANE0 = 13


def image_to_tiles(x: torch.Tensor, image_size: int) -> torch.Tensor:
    """(B,H,W,[D]) image -> (B,Tp,1024,[D]) tile-major, zero-padded to the
    tile grid and to a multiple of 8 tiles."""
    B, H, W = x.shape[:3]
    chan = tuple(x.shape[3:])
    ty = -(-H // TILE_ROWS)
    tx = -(-W // TILE_COLS)
    T = ty * tx
    Tp = -(-T // 8) * 8
    grid = x.new_zeros((B, ty * TILE_ROWS, tx * TILE_COLS) + chan)
    grid[:, :H, :W] = x
    tiles = grid.reshape((B, ty, TILE_ROWS, tx, TILE_COLS) + chan).movedim(3, 2)
    tiles = tiles.reshape((B, T, TILE_PIX) + chan)
    if Tp != T:
        tiles = torch.cat([tiles, tiles.new_zeros((B, Tp - T, TILE_PIX) + chan)], dim=1)
    return tiles


def planes_records(face_verts: torch.Tensor, attributes: torch.Tensor) -> torch.Tensor:
    """The training record: face_records lanes 0-11, lane 12 the face id,
    then attr_planes [PA(D) | PB(D) | PC(D)], zero padded -> (B,F,32)."""
    B, F = face_verts.shape[:2]
    D = attributes.shape[-1]
    base = face_records(face_verts)[..., :13].clone()
    base[..., 12] = torch.arange(F, dtype=base.dtype, device=base.device)
    planes = attr_planes(face_verts, attributes)
    pad = face_verts.new_zeros((B, F, REC5_LANES - 13 - 3 * D))
    return torch.cat([base, planes, pad], dim=-1)


def _winner_and_slot(starts, recs, bidx, bz, win):
    """One group of `_plain_zbuffer` -> (the winners' records (G,Tp,P,L),
    covered, p2f int32 (-1 empty), zbuf (1e10 empty), per-tile slot
    (c - start)*32 + best int32 (-1 empty))."""
    covered = bz < BIG_Z
    wrec = recs[bidx[:, :, None], win]  # (G,Tp,P,L)
    first = starts[bidx[:, 0]].long()[:, :, None] * V3_CHUNK
    return (wrec, covered,
            torch.where(covered, wrec[..., 12].to(torch.int32), -1),
            torch.where(covered, bz, BIG_Z),
            torch.where(covered, win - first, -1).to(torch.int32))


def _planes_plain(starts, ends, recs, image_size: int, tiles_x: int, D: int):
    """`_plain_zbuffer` over records in the REC5_LANES layout + the winner's
    per-tile slot and D planes. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf
    f32 (1e10 empty), slot (B,Tp,1024) int32, the winner's per-tile slot
    (c - start)*32 + best (-1 empty), vals (D,B,Tp,1024) f32 (0 empty)."""
    outs = []
    for group in _plain_zbuffer(starts, ends, recs, image_size, tiles_x):
        wrec, covered, p2f, zbuf, slot = _winner_and_slot(starts, recs, *group[:3])
        x, y = group[3:]
        p0 = _REC5_PLANE0
        vals = [_affine(wrec, p0 + d, p0 + D + d, p0 + 2 * D + d, x, y)
                for d in range(D)]
        outs.append((p2f, zbuf, slot,
                     torch.stack([torch.where(covered, v, 0.0) for v in vals])))
    p2f, zbuf, slot, vals = zip(*outs)
    return (torch.cat(p2f), torch.cat(zbuf), torch.cat(slot), torch.cat(vals, dim=1))


def raster_planes_windows_plain(kept, bins, records, image_size: int, tiles_x: int,
                                D: int):
    """Plain version of K3: `_planes_plain` over chunks 0 .. kept - 1 of
    each tile's gathered bin (`_bin_walk`), every face tested (no cull), so
    the slot is the winner's index k*32 + slot in its tile's bin. -> p2f,
    zbuf, slot (B,Tp,1024), vals (D,B,Tp,1024), as `_planes_plain`."""
    return _planes_plain(*_bin_walk(kept, bins, records), image_size, tiles_x, D)


# u = 2^-24 times the roundings allowed in one fp32 edge test (cull_boxes)
_CULL_ROUNDING = 32 * 2.0 ** -24


def _cull_grid_radius(image_size: int) -> float:
    """The largest |NDC coordinate| of a pixel centre of the tile grid,
    padding included, at least 1: cull_boxes' R before the vertices."""
    ty, tx = _tile_grid(image_size)
    S = float(image_size)
    return max(1.0, (2 * tx * TILE_COLS - 1 - S) / S, (2 * ty * TILE_ROWS - 1 - S) / S)


def _face_boxes(face_verts: torch.Tensor, image_size: int):
    """The cull boxes' common part -> (x, y (B,F,3) NDC vertex coordinates,
    xmin, xmax, ymin, ymax (B,F) pixel coordinates, ext (B,F) the longer
    side in pixels, r (B,F,1) the largest |coordinate| of the tile grid's
    pixel centres and the face's vertices), in the kernels' fp32 order
    (csrc/window_raster.cuh, `face_box`)."""
    S = image_size
    x, y = face_verts[..., 0], face_verts[..., 1]  # (B,F,3)
    px = (x * S + S - 1.0) / 2.0
    py = (y * S + S - 1.0) / 2.0
    xmin, xmax = px.amin(-1), px.amax(-1)
    ymin, ymax = py.amin(-1), py.amax(-1)
    r = torch.cat([x, y], -1).abs().amax(-1, keepdim=True).clamp_min(
        _cull_grid_radius(S))
    return x, y, xmin, xmax, ymin, ymax, torch.maximum(xmax - xmin, ymax - ymin), r


def _boxes_where(exact, xmin, xmax, ymin, ymax) -> torch.Tensor:
    """(B,F,4) [xmin, xmax, ymin, ymax], unbounded where not exact."""
    inf = float("inf")
    return torch.stack([torch.where(exact, xmin, -inf), torch.where(exact, xmax, inf),
                        torch.where(exact, ymin, -inf), torch.where(exact, ymax, inf)],
                       -1).contiguous()


def cull_boxes(face_verts: torch.Tensor, image_size: int) -> torch.Tensor:
    """K1's and K3's per-face cull boxes -> (B,F,4) f32 [xmin, xmax, ymin,
    ymax] in pixel coordinates (pixel centre c at coordinate c): the faces'
    bounding boxes as the binning computes them (`_bbox_and_priority`),
    except that a face too thin for the cull to be exact gets an unbounded
    box and is never culled. K1 and K3 compute the same boxes, with the
    same fp32 operations, as they stage each chunk (`cull_box` in
    csrc/window_raster.cuh); this is their plain statement, for the checks
    and the work counts. K1's records share lanes 0-11, the edge and depth
    planes, with K3's (`face_records`), so one proof serves both.

    The kernels skip a face for a warp when its box widened by one pixel misses
    the warp's pixels. At a pixel at least one pixel outside the box (half
    a pixel left for the box's own rounding) the face's most negative
    sign-normalised edge function is at most -|denom| / (4 ext), ext the
    box's longer side in pixels (the barycentric coordinates there sum to
    1 with a negative part of at least 1 / (2 ext)). Its fp32 evaluation,
    coefficients included, errs by at most ~5u M, M the largest sum over
    an edge of the magnitudes rounded, (|a| + |b|) R + |x_j y_k| +
    |y_j x_k| with R bounding every coordinate (the tile grid's pixel
    centres and the vertices). A face keeps its box where |denom| > 32u M
    (4 ext + 1); there no pixel outside the widened box passes the edge
    tests in fp32, so the cull changes no output. Slivers and
    near-degenerate faces fail the condition and are tested everywhere.
    K8's cross-product form, whose rounding grows with the pixel's
    distance from the face, has a margin of its own: `cull_boxes_bins`."""
    return _affine_cull_boxes(face_verts, image_size, _CULL_ROUNDING)


def _affine_cull_boxes(face_verts: torch.Tensor, image_size: int, rounding: float):
    """`cull_boxes` at a margin of `rounding` (x u) -> (B,F,4)."""
    x, y, xmin, xmax, ymin, ymax, ext, r = _face_boxes(face_verts, image_size)
    xj, yj, xk, yk = x.roll(-1, -1), y.roll(-1, -1), x.roll(-2, -1), y.roll(-2, -1)
    m = (((yj - yk).abs() + (xk - xj).abs()) * r + (xj * yk).abs()
         + (yj * xk).abs()).amax(-1)
    x0, y0 = x[..., 0], y[..., 0]
    x1, y1, x2, y2 = x[..., 1], y[..., 1], x[..., 2], y[..., 2]
    denom = (y1 - y2) * x0 + (x2 - x1) * y0 + (x1 * y2 - y1 * x2)  # face_records'
    exact = denom.abs() > rounding * m * (4.0 * ext + 1.0)
    return _boxes_where(exact, xmin, xmax, ymin, ymax)


# 128u: the margin of K10's rebased forms (cull_boxes_local), 4x cull_boxes'
_LOCAL_CULL_ROUNDING = 128 * 2.0 ** -24


def cull_boxes_local(face_verts: torch.Tensor, image_size: int) -> torch.Tensor:
    """K10's per-face cull boxes -> (B,F,4) f32: `cull_boxes`' boxes with a
    margin of 128u in place of 32u, for edge tests on records rebased to
    tile-local coordinates (`_tilelocal_adjust`). K10
    (csrc/raster_groups.cu) computes the same boxes in its staging and
    tests them against the warp rectangles at the tile's real position.

    Why the margin covers the rebase. K10 evaluates e' = fl(s1 + c'),
    s1 = fl(fl(a xl) + fl(b yl)) at the first tile's pixel centre (xl, yl)
    and c' = fl(c + fl(fl(a dx) + fl(b dy))), (dx, dy) the offset of the
    tile's origin, against E = a (xl + dx) + b (yl + dy) + c in exact
    arithmetic on the same fp32 values; xl + dx lies within u (|xl| +
    |dx|) of the pixel's exact centre. The last rounding keeps e''s sign,
    so what can flip it is at most 2u P + 3u Q + u |c|, P = |a||xl| +
    |b||yl| and Q = |a||dx| + |b||dy|, to first order. Every local centre
    is a pixel centre of the grid, so |xl|, |yl| <= R, and dx, dy <= R + 1
    <= 2R (R >= 1 `cull_boxes`' radius). With the coefficients' own
    rounding and the centre's, the error is below ~12u M (M as in
    `cull_boxes`), where `cull_boxes` bounds the unrebased form's by ~4u M
    (its final rounding also keeps the sign): three times as much, and a
    margin of 128u M (4 ext + 1) keeps `cull_boxes`' headroom over it.
    Slivers and near-degenerate faces fail the condition and are tested
    everywhere, as there."""
    return _affine_cull_boxes(face_verts, image_size, _LOCAL_CULL_ROUNDING)


# 512u = 2^-15: K8's cull margin (cull_boxes_bins), 4x the bound it derives
_BINS_CULL_ROUNDING = 512 * 2.0 ** -24


def cull_boxes_bins(face_verts: torch.Tensor, image_size: int) -> torch.Tensor:
    """K8's per-face cull boxes -> (B,F,4) f32 [xmin, xmax, ymin, ymax] in
    pixel coordinates, the bounding boxes of `cull_boxes` with a margin
    derived for K8's arithmetic: a face keeps its box where

        |denom| S^2 > 512u (ext + 1) ((ext + 2)^2 + R S),

    denom = (x1 - x0)(y2 - y0) - (y1 - y0)(x2 - x0) its fp32 cross-product
    area as K8 computes it, S the image size, ext the box's longer side in
    pixels, R `cull_boxes`' radius (every pixel centre of the tile grid and
    every vertex lies in [-R, R]^2 in NDC), u = 2^-24; otherwise it gets an
    unbounded box. K8 (csrc/raster_bins.cu, `bins_cull_box`) computes the
    same boxes with the same fp32 operations in its staging; it also skips
    the faces it never tests (past the count, |denom| < 1e-10).

    Why no pixel outside the box widened by one pixel passes K8's test
    w_i = fl(fl(e_i) / safe) >= 0 for all i. In exact arithmetic, with the
    fp32 vertices and pixel centres as given, e_i = (x_j - x)(y_k - y) -
    (y_j - y)(x_k - x) is D lambda_i, lambda the pixel's barycentric
    coordinates and D the exact area. Let h = 2/S be a pixel in NDC, e
    (<= h (ext + 1)) the exact box's longer side and g the pixel's distance
    from it in the max norm, at least h/2 for a pixel more than one pixel
    out (half a pixel left for the box's and the centre's own rounding).
    Writing the pixel's coordinate on the axis of that distance as the
    lambda-weighted vertices' shows that the negative lambda sum to at
    least g / e, so min lambda <= -g / (2e) and |e_i| >= |D| g / (2e) for
    that i. Each factor x_j - x of e_i is rounded once and is at most e + g
    in magnitude, so fl(e_i) errs by at most gamma_4 (|P| + |Q|) <= 2
    gamma_4 (e + g)^2 (gamma_4 = 4u / (1 - 4u); P, Q the two products).
    A pass is impossible when |D| g / (2e) exceeds that for every g in
    [h/2, 2R], i.e. when |D| > 4 gamma_4 e max phi, phi(g) = (e + g)^2 / g
    convex, so largest at an end: phi(h/2) <= 2h (ext + 2)^2 and phi(2R)
    <= 2e + 4R, together at most 2h (ext + 2)^2 + 4R. The kept faces have
    |fl(denom)| above 64u h (ext + 1)(2h (ext + 2)^2 + 4R) (the condition
    above, divided by S^2), 4x that bound; fl(denom) errs from D by at
    most 2 gamma_4 e^2, under 2 % of it, so the sign of safe is D's and |D|
    keeps a factor over 3.5 for the roundings of the box and of the
    condition. Then fl(e_i) has the sign opposite to
    safe and |fl(e_i)| > 20u (e + g)^2, while |safe| <= 2.01 e^2, so the
    quotient is below -9u: negative, never an underflow to -0. Slivers and
    near-degenerate faces fail the condition and are tested everywhere.
    `cull_boxes`' margin was derived for the records' affine form, whose
    rounding its M bounds by the coefficients; it is not shown to cover
    this form, whose products P, Q grow with the pixel's distance from the
    face (to about R^2)."""
    S = image_size
    x, y, xmin, xmax, ymin, ymax, ext, r = _face_boxes(face_verts, S)
    x0, y0 = x[..., 0], y[..., 0]
    x1, y1, x2, y2 = x[..., 1], y[..., 1], x[..., 2], y[..., 2]
    denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # K8's
    e2 = ext + 2.0
    exact = (denom.abs() * S * S
             > _BINS_CULL_ROUNDING * (ext + 1.0) * (e2 * e2 + r[..., 0] * S))
    return _boxes_where(exact, xmin, xmax, ymin, ymax)


def raster_planes_windows(kept, bins, records, face_verts, image_size: int, tiles_x: int,
                          D: int):
    """K3: per-tile z-buffer over chunks 0 .. kept - 1 of the tile's bin +
    the winner's per-tile slot and D attribute planes (the differentiable
    raster's forward). kept (B,Tp) int32 (`_windows`), bins (B,Tp,C)
    int32, records (B,F,32) f32 (`planes_records`), face_verts (B,F,3,3)
    f32 (the faces the records were built from; the kernel culls with
    them) -> as `raster_planes_windows_plain`.

    Replaces `_raster_kernel_v5c` (compact record list) and
    `_raster_kernel_v5` (padded layout) (smirk_tpu/render/rasterizer.py).
    Bound on H100: fp32 operations (~16 per face-pixel test), with FMAs
    forbidden so that it stays bitwise equal to the plain version. Design:
    K1's read-through staging; as a chunk is staged, each face's cull box
    (`cull_boxes`) is computed from its vertices beside its record. The 8
    warps of a block each own a 16x8 pixel rectangle of the tile, and a
    warp skips a face whose box widened by one pixel misses its rectangle
    (a warp-uniform test that `cull_boxes` makes exact), so the number of
    face-pixel tests, not their cost, is what falls. The slot and the D
    planes of the winner are evaluated once, at the end. A kept count is
    clamped to [0, C/32]. CPU tensors take the plain version, which tests
    every face.
    """
    if records.device.type == "cpu":
        return raster_planes_windows_plain(kept, bins, records, image_size, tiles_x, D)
    if records.device.type != "cuda":
        raise ValueError(f"raster_planes_windows: unsupported device {records.device}")
    dev = records.device
    B, Tp, C, F = _check_read_through("raster_planes_windows", kept, bins, records,
                                      face_verts, REC5_LANES)
    if not 1 <= D <= (REC5_LANES - 13) // 3:
        raise ValueError(f"raster_planes_windows: D {D} not in [1, "
                         f"{(REC5_LANES - 13) // 3}]")
    p2f = torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
    zbuf = torch.empty((B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    slot = torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
    vals = torch.empty((D, B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    lib = kernels.library("raster_planes")
    rc = lib.smirk_raster_planes_windows(
        kept.data_ptr(), bins.data_ptr(), records.data_ptr(), face_verts.data_ptr(),
        p2f.data_ptr(), zbuf.data_ptr(), slot.data_ptr(), vals.data_ptr(),
        B, Tp, C, F, image_size, image_size, tiles_x, D, _cull_grid_radius(image_size),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_planes_windows")
    raster_planes_windows.launches += 1
    return p2f, zbuf, slot, vals


raster_planes_windows.launches = 0


def moment_rows(g: torch.Tensor, image_size: int) -> torch.Tensor:
    """g (B,Tp,1024,D) tile-major -> (B,Tp,1024,3D) [g*x | g*y | g], x and y
    the pixel centres."""
    Tp = g.shape[1]
    xs, ys = _tile_centers(Tp, image_size, -(-image_size // TILE_COLS), g.device)
    return torch.cat([g * xs[None, :, :, None], g * ys[None, :, :, None], g], dim=-1)


def slot_index(slots: torch.Tensor, capacity: int, width: int) -> torch.Tensor:
    """slots (B,Tp,1024) -> (B, Tp*1024, width) int64 rows t*C + slot of a
    (B, Tp*C + 1) table, slots outside [0, C) to the dropped last row;
    expanded (no copy) over `width` channels, as scatter_add_ takes it."""
    B, Tp, P = slots.shape
    tile = torch.arange(Tp, device=slots.device)[None, :, None] * capacity
    idx = torch.where((slots >= 0) & (slots < capacity), tile + slots.long(),
                      Tp * capacity)
    return idx.reshape(B, Tp * P, 1).expand(B, Tp * P, width)


def segment_sum(slots, rows, capacity: int):
    """Per-(tile, slot) sums of per-pixel rows (B,Tp,1024,W) by one
    scatter_add_ -> (B,Tp,C,W)."""
    B, Tp, P, Wd = rows.shape
    out = rows.new_zeros((B, Tp * capacity + 1, Wd))
    out.scatter_add_(1, slot_index(slots, capacity, Wd), rows.reshape(B, Tp * P, Wd))
    return out[:, :Tp * capacity].reshape(B, Tp, capacity, Wd)


def _channel_group(lib, capacity: int, channels: int, device, reserve: int = 0) -> int:
    """Channels per block of a per-(tile, slot) reduction whose capacity x
    channels fp32 accumulators live in shared memory beside `reserve`
    other bytes: all of them where they fit in the device's opt-in limit
    per block, else the fewest groups of near-equal width that fit."""
    limit = lib.smirk_max_shared_optin(device.index)
    if limit <= 0:
        raise RuntimeError("could not read the device's shared memory limit")
    limit -= reserve
    if capacity * 4 > limit:
        raise ValueError(f"capacity {capacity}: one channel of accumulators "
                         f"exceeds the {limit} bytes of shared memory per block")
    groups = -(-capacity * channels * 4 // limit)
    return -(-channels // groups)


def segment_moments_plain(slots, g, capacity: int, image_size: int):
    """Plain version of K4: the moment rows, then one scatter_add_ into the
    (B, Tp*C) slot rows (-1 slots go to a dropped row). -> (B,Tp,C,3D)."""
    return segment_sum(slots, moment_rows(g, image_size), capacity)


def _check_moments(name, slots, g):
    """K4's argument checks on the card -> (B, Tp, D)."""
    _check_cuda("slots", slots, torch.int32, 3, g.device)
    _check_cuda("g", g, torch.float32, 4, g.device)
    B, Tp, P, D = g.shape
    if tuple(slots.shape) != (B, Tp, P) or P != TILE_PIX:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"slots {tuple(slots.shape)} g {tuple(g.shape)}")
    return B, Tp, D


def segment_moments(slots, g, capacity: int, image_size: int):
    """K4 with its store epilogue: per-(tile, slot) sums of [g*x | g*y | g]
    over the pixels the slot won; slots (B,Tp,1024) int32 (-1 = none), g
    (B,Tp,1024,D) f32 tile-major -> (B,Tp,C,3D) f32, zeros for slots that
    won nothing.

    Replaces `_segment_moments_kernel` (`segment_reduce_moments`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes (slots + g read
    once, the rows written once; ~16 us at b32, 224 px). Design: one block
    per (tile, image) with the tile's C x 3D accumulators in shared memory
    (dynamic, past 48 KB by opt-in; the 3D channels split into groups over
    the grid where even the opt-in limit is too small), a warp's pixels on
    one slot summed with shuffles before one set of shared-memory atomics,
    one coalesced store; the atomics make the float
    order vary, so it matches the plain version within a tolerance, not
    bitwise. The training backward runs the fold epilogue instead
    (`segment_moments_to_faces`). CPU tensors take the plain version.
    """
    if g.device.type == "cpu":
        return segment_moments_plain(slots, g, capacity, image_size)
    if g.device.type != "cuda":
        raise ValueError(f"segment_moments: unsupported device {g.device}")
    dev = g.device
    B, Tp, D = _check_moments("segment_moments", slots, g)
    out = torch.empty((B, Tp, capacity, 3 * D), dtype=torch.float32, device=dev)
    lib = kernels.library("segment_moments")
    group = _channel_group(lib, capacity, 3 * D, dev, K4_CENTRE_BYTES)
    rc = lib.smirk_segment_moments(
        slots.data_ptr(), g.data_ptr(), out.data_ptr(), B, Tp, capacity, D,
        group, image_size, image_size, -(-image_size // TILE_COLS), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "segment_moments")
    segment_moments.launches += 1
    return out


segment_moments.launches = 0


def segment_moments_to_faces_plain(slots, g, bins, capacity: int, image_size: int, F: int):
    """Plain version of K4's fold epilogue: the plain per-slot table, then
    the plain fold. -> (B,F,3D)."""
    return fold_slots_to_faces_plain(segment_moments_plain(slots, g, capacity, image_size),
                                     bins, F)


# K4's shared bytes beside its accumulators: the tile's 136 pixel centres
K4_CENTRE_BYTES = (TILE_COLS + TILE_ROWS) * 4


def _fold_reserve(capacity: int) -> int:
    """Shared bytes of K4's fold epilogue beside its accumulators: the
    pixel centres, one mark byte a slot (whole words) and the per-warp
    lists of 32 slots and face ids of its 8 warps."""
    return K4_CENTRE_BYTES + -(-capacity // 4) * 4 + 2 * 8 * 32 * 4


def segment_moments_to_faces(slots, g, bins, capacity: int, image_size: int, F: int):
    """K4 with its fold epilogue: the per-face totals of the moments,
    `fold_slots_to_faces(segment_moments(slots, g, capacity, image_size),
    bins, F)` without the per-slot table; bins (B,Tp,C) int32 face ids (< 0
    or >= F dropped) -> (B,F,3D) f32.

    Replaces `_segment_moments_kernel` followed by `_fold_kernel`
    (smirk_tpu/render/rasterizer.py), the training backward's pair. Bound on
    H100: bytes (the slots, g at the pixels with a live slot, the bin ids
    of the slots a pixel reached and the face table, each once; ~5 us at
    b32, 224 px, C=384, D=3). Design:
    K4's walk, which also marks the slots a pixel reached; each warp then
    reads 32 bin ids of its tile, lists the marked slots holding a face and
    adds their nonzero sums into the zeroed face table with global atomics
    (a face sits in at most one slot of a tile). The atomics make the float
    order vary, so it matches the plain version within a tolerance. A
    `bins` that does not match the slots raises ValueError on any device;
    CPU tensors take the plain version.
    """
    B, Tp = g.shape[:2]
    if tuple(bins.shape) != (B, Tp, capacity):
        raise ValueError("segment_moments_to_faces: bins must be (B, Tp, capacity) = "
                         f"{(B, Tp, capacity)}, got {tuple(bins.shape)}")
    if g.device.type == "cpu":
        return segment_moments_to_faces_plain(slots, g, bins, capacity, image_size, F)
    if g.device.type != "cuda":
        raise ValueError(f"segment_moments_to_faces: unsupported device {g.device}")
    dev = g.device
    B, Tp, D = _check_moments("segment_moments_to_faces", slots, g)
    _check_cuda("bins", bins, torch.int32, 3, dev)
    out = torch.zeros((B, F, 3 * D), dtype=torch.float32, device=dev)
    lib = kernels.library("segment_moments")
    group = _channel_group(lib, capacity, 3 * D, dev, _fold_reserve(capacity))
    rc = lib.smirk_segment_moments_to_faces(
        slots.data_ptr(), g.data_ptr(), bins.data_ptr(), out.data_ptr(), B, Tp,
        capacity, D, group, image_size, image_size, -(-image_size // TILE_COLS), F,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "segment_moments_to_faces")
    segment_moments_to_faces.launches += 1
    return out


segment_moments_to_faces.launches = 0


def _fold_index(bins: torch.Tensor, F: int) -> torch.Tensor:
    """bins (B,Tp,C) -> flat (B*Tp*C,) rows b*F + id of a (B*F + 1) table;
    ids outside [0, F) go to the dropped last row."""
    B = bins.shape[0]
    ids = bins.reshape(B, -1).long()
    b = torch.arange(B, device=bins.device)[:, None] * F
    return torch.where((ids >= 0) & (ids < F), b + ids, B * F).reshape(-1)


def fold_slots_to_faces_plain(per_slot, bins, F: int):
    """Plain version of K5, and the "scatter" fold mode: one index_add_
    over (B*F) rows. -> (B,F,CHN)."""
    B, Tp, C, CHN = per_slot.shape
    out = per_slot.new_zeros((B * F + 1, CHN))
    out.index_add_(0, _fold_index(bins, F), per_slot.reshape(-1, CHN))
    return out[:B * F].reshape(B, F, CHN)


def _fold_sorted(per_slot, bins, F: int, mode: str):
    """The "sorted_scatter" and "cumsum" fold modes, per image as the JAX
    package's: the ids (outside [0, F) -> F, last) sorted stably with their
    rows, then an index_add_ in that order ("sorted_scatter"), or each
    face's total as the difference of the rows' prefix sums at its run's
    bounds, found by searchsorted ("cumsum"). -> (B,F,CHN). The prefix
    sums are float64: in fp32 they round at the scale of all the image's
    rows before the face (the JAX package's do), while a total should keep
    the precision of a sum of its own rows."""
    B, Tp, C, CHN = per_slot.shape
    ids = bins.reshape(B, Tp * C).long()
    ids = torch.where((ids >= 0) & (ids < F), ids, F)
    sids, order = torch.sort(ids, dim=1, stable=True)
    rows = torch.take_along_dim(per_slot.reshape(B, Tp * C, CHN), order[..., None], dim=1)
    if mode == "sorted_scatter":
        flat = sids + torch.arange(B, device=ids.device)[:, None] * (F + 1)
        out = per_slot.new_zeros((B * (F + 1), CHN))
        out.index_add_(0, flat.reshape(-1), rows.reshape(-1, CHN))
        return out.reshape(B, F + 1, CHN)[:, :F]
    csum = torch.cumsum(rows, dim=1, dtype=torch.float64)
    faces = torch.arange(F, device=ids.device).expand(B, F).contiguous()
    lo = torch.searchsorted(sids, faces, side="left")
    hi = torch.searchsorted(sids, faces, side="right")

    def take(i):
        return torch.take_along_dim(csum, i.clamp_min(0)[..., None], dim=1)

    lower = torch.where((lo > 0)[..., None], take(lo - 1), 0.0)
    return torch.where((hi > lo)[..., None], take(hi - 1) - lower, 0.0).to(per_slot.dtype)


# The fold of per-(tile, slot) rows into faces, a process global as in the
# JAX package: "matmul" (the JAX package's Pallas fold; here K5, and on the
# training backward K4's fold epilogue), "scatter" (one index_add_),
# "sorted_scatter" (a stable sort of the ids, then index_add_ in that
# order), "cumsum" (a stable sort, prefix sums and searchsorted
# differences).
FOLD_MODES = ("matmul", "scatter", "sorted_scatter", "cumsum")
_FOLD_MODE = "matmul"


def set_fold_mode(mode: str) -> None:
    """Set the fold mode of `fold_slots_to_faces` and of the training
    backward (`rasterize_planes_diff`): one of FOLD_MODES."""
    global _FOLD_MODE
    if mode not in FOLD_MODES:
        raise ValueError(f"fold mode must be one of {FOLD_MODES}, got {mode!r}")
    _FOLD_MODE = mode


def fold_slots_to_faces(per_slot, bins, F: int):
    """K5: per-face totals of per-(tile, slot) rows; per_slot (B,Tp,C,CHN)
    f32, bins (B,Tp,C) int32 face ids (< 0 or >= F dropped) -> (B,F,CHN)
    f32. The rows of dropped slots are never read. Outside the "matmul"
    fold mode (`set_fold_mode`) the mode's PyTorch ops fold instead, on
    any device, and K5 is not launched.

    Replaces `_fold_kernel` (`_fold_matmul` / `fold_slots_to_faces`,
    smirk_tpu/render/rasterizer.py); served after K7 on the op path.
    Bound on H100: bytes (the bins, the rows of slots that hold a face and
    the face table, each once; ~12 us at b32, 224 px, C=512, CHN=36).
    Design: one warp per run of 32 slot rows of an image: one coalesced
    read of their bin ids, a ballot of those in [0, F), then only those
    rows read (float4 pieces where CHN % 4 == 0 and per_slot is 16-byte
    aligned, 4-byte pieces otherwise) and their nonzero pieces added into
    the zeroed output with atomics; a face appears once per tile, so its
    atomics rarely collide. The float order varies, so it matches the
    plain version within a tolerance. CPU tensors take the plain version.
    """
    if _FOLD_MODE == "scatter":
        return fold_slots_to_faces_plain(per_slot, bins, F)
    if _FOLD_MODE != "matmul":
        return _fold_sorted(per_slot, bins, F, _FOLD_MODE)
    if per_slot.device.type == "cpu":
        return fold_slots_to_faces_plain(per_slot, bins, F)
    if per_slot.device.type != "cuda":
        raise ValueError(f"fold_slots_to_faces: unsupported device {per_slot.device}")
    dev = per_slot.device
    _check_cuda("per_slot", per_slot, torch.float32, 4, dev)
    _check_cuda("bins", bins, torch.int32, 3, dev)
    B, Tp, C, CHN = per_slot.shape
    if tuple(bins.shape) != (B, Tp, C):
        raise ValueError("fold_slots_to_faces: inconsistent shapes "
                         f"per_slot {tuple(per_slot.shape)} bins {tuple(bins.shape)}")
    if max(Tp * C, F) * CHN >= 2 ** 31 or B > 65535:
        raise ValueError("fold_slots_to_faces: an image's rows or the face table "
                         "exceed 32-bit indexing, or B > 65535")
    out = torch.zeros((B, F, CHN), dtype=torch.float32, device=dev)
    vec = CHN % 4 == 0 and per_slot.data_ptr() % 16 == 0
    lib = kernels.library("fold_faces")
    rc = lib.smirk_fold_faces(
        per_slot.data_ptr(), bins.data_ptr(), out.data_ptr(), B, Tp * C, CHN, F,
        int(vec), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fold_slots_to_faces")
    fold_slots_to_faces.launches += 1
    return out


fold_slots_to_faces.launches = 0

# ---------------------------------------------------------------------------
# The coverage rasters (K6, K8) and the payload reduction (K7)
# ---------------------------------------------------------------------------

REC_LANES = 16  # [a0 b0 c0 a1 b1 c1 a2 b2 c2 zA zB zC fid pad pad pad]


def raster_coverage_windows_plain(kept, bins, records, image_size: int, tiles_x: int):
    """Plain version of K6: `_plain_zbuffer` over chunks 0 .. kept - 1 of
    each tile's gathered bin (`_bin_walk`) of records in the REC_LANES
    layout, every face tested (no cull). kept (B,Tp) int32, bins (B,Tp,C)
    int32, records (B,F,16) (`coverage_records`) -> p2f (B,Tp,1024) int32
    (-1 empty), zbuf f32 (1e10 empty), slot (B,Tp,1024) int32, the winner's
    index k*32 + slot in its tile's bin (-1 empty). A 2-D bins (the old
    (starts, ends, recs) form) raises ValueError."""
    starts, ends, recs = _bin_walk(kept, bins, records)
    outs = [_winner_and_slot(starts, recs, *group[:3])[2:]
            for group in _plain_zbuffer(starts, ends, recs, image_size, tiles_x)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def raster_coverage_windows(kept, bins, records, face_verts, image_size: int,
                            tiles_x: int):
    """K6: per-tile coverage z-buffer over chunks 0 .. kept - 1 of the
    tile's bin. kept (B,Tp) int32 (`_windows`), bins (B,Tp,C) int32,
    records (B,F,16) f32 (`coverage_records`), face_verts (B,F,3,3) f32
    (the faces the records were built from; the kernel culls with them) ->
    as `raster_coverage_windows_plain`.

    Replaces `_raster_kernel_v3` (via `_v3_impl`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes, once the cull
    skips the faces a warp cannot see (unculled, fp32 operations: ~16 per
    face-pixel test), with FMAs forbidden so that it stays bitwise equal to
    the plain version. Design: K3's walk (`raster_planes_windows`;
    csrc/window_raster.cuh at 16 floats a record): the records read
    through the bins, the block's halves staging alternate chunks two
    ahead, each face's cull box (`cull_boxes`, exact for these records'
    lanes 0-11) computed from its vertices; each of the 8 warps owns a 16x8
    pixel rectangle and skips a face whose box widened by one pixel misses
    it. The winner's face id is read from the bin row. A kept count is
    clamped to [0, C/32]. Bitwise equal to its plain version and to K3's
    coverage outputs on the same bins. CPU tensors take the plain version.
    """
    if records.device.type == "cpu":
        return raster_coverage_windows_plain(kept, bins, records, image_size, tiles_x)
    if records.device.type != "cuda":
        raise ValueError(f"raster_coverage_windows: unsupported device {records.device}")
    dev = records.device
    B, Tp, C, F = _check_read_through("raster_coverage_windows", kept, bins, records,
                                      face_verts, REC_LANES)
    p2f, slot = (torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
                 for _ in range(2))
    zbuf = torch.empty((B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    lib = kernels.library("raster_coverage")
    rc = lib.smirk_raster_coverage_windows(
        kept.data_ptr(), bins.data_ptr(), records.data_ptr(), face_verts.data_ptr(),
        p2f.data_ptr(), zbuf.data_ptr(), slot.data_ptr(), B, Tp, C, F, image_size,
        image_size, tiles_x, _cull_grid_radius(image_size), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_coverage_windows")
    raster_coverage_windows.launches += 1
    return p2f, zbuf, slot


raster_coverage_windows.launches = 0

# K7's accumulators per block: small enough for 6-8 resident blocks an SM
# (228 KB of shared memory on an H100 SM), where one block of all C x CHN
# (74 KB at C=512, CHN=36) left 3; beside them a block lists its pixels
# (K7_LIST_BYTES)
K7_BLOCK_BYTES = 32 * 1024
K7_LIST_BYTES = TILE_PIX * 4


def _reduce_blocks(capacity: int, channels: int, limit: int) -> Tuple[int, int]:
    """K7's block: (channels, slots) of the accumulators it holds. All the
    channels where a row takes at most 32 lanes of 16 bytes (128 channels,
    a multiple of 4 for float4 pieces) or of 4 bytes (32 channels
    otherwise), else the fewest even groups under that, each a multiple of
    4 where `channels` is one; then the longest run of slots whose rows fit
    K7_BLOCK_BYTES (and `limit`, the device's opt-in bytes per block, with
    the pixel list), evened out over the runs the capacity needs, each a
    multiple of 8 slots (whole 128-byte lines of output at a multiple of 4
    channels) unless one run holds them all."""
    vec = channels % 4 == 0
    most = 128 if vec else 32
    groups = -(-channels // most)
    width = -(-channels // groups)
    if vec:
        width = -(-width // 4) * 4
    width = min(width, channels)
    room = min(K7_BLOCK_BYTES, limit - K7_LIST_BYTES) // (width * 4)
    if room < 8:
        raise ValueError(f"{limit} bytes of shared memory per block cannot hold K7's "
                         f"rows of {width} channels")
    if room >= capacity:
        return width, capacity
    room -= room % 8
    runs = -(-capacity // room)
    return width, -(-capacity // (runs * 8)) * 8  # <= room, a multiple of 8


def segment_reduce_tiles(slots, payload, capacity: int):
    """K7: per-(tile, slot) sums of a per-pixel payload; slots (B,Tp,1024)
    int32 (-1 = none; the tile grid's padding pixels hold slot 0 with a
    zero payload), payload (B,Tp,1024,CHN) f32 tile-major, 16-byte aligned
    -> (B,Tp,C,CHN) f32, zeros for slots that won nothing. Rows whose slot
    is outside [0, C) are dropped, and the kernel never reads them.

    Replaces `_segment_reduce_kernel` (`segment_reduce_tiles`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes (the slots, the
    payload rows of slots in [0, C) and the output rows, each once).
    Design: one block per (run of slots, tile, image), the run fastest,
    with the run's rows of accumulators in dynamic shared memory, sized for
    6-8 resident blocks an SM (`_reduce_blocks`; past 128 channels also a
    channel group). The block reads the tile's slots once, lists the pixels
    whose slot is in its run and loads only their rows (float4 pieces);
    shared-memory atomics, then one contiguous float4 store of its rows.
    The atomics make the float order vary, so it matches its plain
    version, `segment_sum` (one scatter_add_), within a tolerance. CPU
    tensors take the plain version.
    """
    if payload.device.type == "cpu":
        return segment_sum(slots, payload, capacity)
    if payload.device.type != "cuda":
        raise ValueError(f"segment_reduce_tiles: unsupported device {payload.device}")
    dev = payload.device
    _check_cuda("slots", slots, torch.int32, 3, dev)
    _check_cuda("payload", payload, torch.float32, 4, dev)
    B, Tp, P, CHN = payload.shape
    if tuple(slots.shape) != (B, Tp, P) or P != TILE_PIX or CHN < 1:
        raise ValueError("segment_reduce_tiles: inconsistent shapes "
                         f"slots {tuple(slots.shape)} payload {tuple(payload.shape)}")
    if payload.data_ptr() % 16 or slots.data_ptr() % 16:
        raise ValueError("segment_reduce_tiles: slots and payload must be 16-byte aligned")
    out = torch.empty((B, Tp, capacity, CHN), dtype=torch.float32, device=dev)
    lib = kernels.library("segment_reduce")
    limit = lib.smirk_max_shared_optin(dev.index)
    if limit <= 0:
        raise RuntimeError("could not read the device's shared memory limit")
    group, span = _reduce_blocks(capacity, CHN, limit)
    rc = lib.smirk_segment_reduce_tiles(
        slots.data_ptr(), payload.data_ptr(), out.data_ptr(), B, Tp, capacity,
        CHN, group, span, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "segment_reduce_tiles")
    segment_reduce_tiles.launches += 1
    return out


segment_reduce_tiles.launches = 0


def raster_bins_coverage_plain(counts, bins, fv9, image_size: int):
    """Plain version of K8: each tile walks the first `count` faces of its
    bin in bin order, 32 at a time; within a block of 32 the first minimum
    wins, and a later block only if strictly nearer, which equals the
    sequential strict-< walk. The arithmetic is the kernel's: cross-product
    edge terms, w = e / area (a tensor divisor, so IEEE on the card),
    z = w0*z0 + w1*z1 + w2*z2. counts (B,Tp) int32, bins (B,Tp,C) int32,
    fv9 (B,F,9) f32 -> p2f (B,Hp,Wp) int32 (-1 empty), zbuf f32 (1e10
    empty), Hp and Wp the tile grid's."""
    B = counts.shape[0]
    dev = fv9.device
    ty, tx = _tile_grid(image_size)
    T = ty * tx
    CH = V3_CHUNK
    xs, ys = _tile_centers(T, image_size, tx, dev)
    xs, ys = xs[None, :, None, :], ys[None, :, None, :]  # (1,T,1,P)
    slot = torch.arange(CH, device=dev)
    group = max(1, _PLAIN_BLOCK_ELEMS // (T * CH * TILE_PIX))
    p2f_parts, z_parts = [], []
    for b0 in range(0, B, group):
        cnt = counts[b0:b0 + group, :T].long()
        G = cnt.shape[0]
        bidx = torch.arange(b0, b0 + G, device=dev)[:, None, None]
        bz = torch.full((G, T, 1, TILE_PIX), BIG_Z, device=dev)
        bf = torch.full((G, T, 1, TILE_PIX), -1, dtype=torch.int32, device=dev)
        for i0 in range(0, int(cnt.max()) if G else 0, CH):
            ids = bins[b0:b0 + G, :T, i0:i0 + CH]  # (G,T,n), n <= CH
            sl = slot[:ids.shape[-1]]
            active = (i0 + sl) < cnt[..., None]
            v = fv9[bidx, ids.clamp_min(0).long()][..., None, :]  # (G,T,CH,1,9)
            x0, y0, z0, x1, y1, z1, x2, y2, z2 = v.unbind(-1)
            denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
            real = denom.abs() >= AREA_EPS
            safe = torch.where(real, denom, 1.0)
            w0 = ((x1 - xs) * (y2 - ys) - (y1 - ys) * (x2 - xs)) / safe
            w1 = ((x2 - xs) * (y0 - ys) - (y2 - ys) * (x0 - xs)) / safe
            w2 = ((x0 - xs) * (y1 - ys) - (y0 - ys) * (x1 - xs)) / safe
            z = w0 * z0 + w1 * z1 + w2 * z2
            inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & real
                      & active[..., None])
            zm = torch.where(inside, z, BIG_Z)
            cz = zm.amin(dim=2, keepdim=True)
            best = torch.where(zm == cz, sl[:, None], CH).amin(dim=2)  # (G,T,P)
            better = cz < bz
            bz = torch.where(better, cz, bz)
            fid = torch.gather(ids, 2, best.clamp(max=len(sl) - 1))
            bf = torch.where(better, fid[:, :, None, :], bf)
        p2f_parts.append(bf[:, :, 0])
        z_parts.append(bz[:, :, 0])

    def to_grid(x):
        x = torch.cat(x).reshape(B, ty, tx, TILE_ROWS, TILE_COLS)
        return x.permute(0, 1, 3, 2, 4).reshape(B, ty * TILE_ROWS, tx * TILE_COLS)

    return to_grid(p2f_parts), to_grid(z_parts)


def raster_bins_coverage(counts, bins, fv9, image_size: int):
    """K8: per-tile z-buffer over the tile's bin, one face at a time ->
    as `raster_bins_coverage_plain`.

    Replaces `_raster_kernel` (via `rasterize_coverage_pallas`,
    smirk_tpu/render/rasterizer.py). Bound on H100: unculled, fp32
    operations (~29 per face-pixel test: 21 for the edge terms, 3
    divisions, 5 for the depth, over count x 1024 pairs per tile); counting
    only the pairs in the faces' boxes, bytes. Design: one block per (tile,
    image); all 256 threads stage 32 bin entries at a time one chunk ahead
    of the tests (ids, vertices, each face's area and its cull box,
    `cull_boxes_bins`, computed in the staging), and each of the 8 warps,
    owning a 16x8 pixel rectangle, tests only the faces whose box widened
    by one pixel meets it, in bin order. A pixel where some e_i has the
    sign opposite to the area's, with |e_i| >= 2^-100 and |area| <= 2^40,
    is rejected before the divisions: that w_i is at most -2^-140, never a
    -0 that would pass w_i >= 0. Every operation is an IEEE `__f*_rn`
    intrinsic (`__fdiv_rn` for the barycentrics), so it is bitwise equal
    to its plain version, which tests every face and divides everywhere.
    CPU tensors take the plain version.
    """
    if fv9.device.type == "cpu":
        return raster_bins_coverage_plain(counts, bins, fv9, image_size)
    if fv9.device.type != "cuda":
        raise ValueError(f"raster_bins_coverage: unsupported device {fv9.device}")
    dev = fv9.device
    _check_cuda("counts", counts, torch.int32, 2, dev)
    _check_cuda("bins", bins, torch.int32, 3, dev)
    _check_cuda("fv9", fv9, torch.float32, 3, dev)
    B, Tp = counts.shape
    C = bins.shape[2]
    F = fv9.shape[1]
    ty, tx = _tile_grid(image_size)
    if (tuple(bins.shape[:2]) != (B, Tp) or fv9.shape[0] != B or fv9.shape[2] != 9
            or Tp < ty * tx):
        raise ValueError("raster_bins_coverage: inconsistent shapes "
                         f"counts {tuple(counts.shape)} bins {tuple(bins.shape)} "
                         f"fv9 {tuple(fv9.shape)} image_size {image_size}")
    p2f = torch.empty((B, ty * TILE_ROWS, tx * TILE_COLS), dtype=torch.int32, device=dev)
    zbuf = torch.empty((B, ty * TILE_ROWS, tx * TILE_COLS), dtype=torch.float32,
                       device=dev)
    lib = kernels.library("raster_bins")
    rc = lib.smirk_raster_bins_coverage(
        counts.data_ptr(), bins.data_ptr(), fv9.data_ptr(), p2f.data_ptr(),
        zbuf.data_ptr(), B, Tp, ty * tx, C, F, image_size, image_size, tx,
        _cull_grid_radius(image_size), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_bins_coverage")
    raster_bins_coverage.launches += 1
    return p2f, zbuf


raster_bins_coverage.launches = 0

KERNELS = (raster_fused_windows, raster_planes_windows,
           segment_moments, segment_moments_to_faces, fold_slots_to_faces,
           raster_coverage_windows, segment_reduce_tiles, raster_bins_coverage,
           raster_fused_groups, raster_fused_groups_local, raster_chunkskip)


def _v5_impl(face_verts, attributes, image_size: int, capacity: int,
             compact: Optional[int] = None, *, bin_approx: Optional[float] = None,
             bin_miss_check: bool = False):
    """The differentiable raster's forward on detached inputs -> (vals
    (B,H,W,D), pix_to_face (B,H,W), zbuf (B,H,W), slots (B,Tp,1024)
    tile-major per-tile slots, bins (B,Tp,C), overflow (B,) int32).

    compact: chunk budget of the compact layout (rounded up to 8, as the
    inference raster's); None = padded layout. overflow counts compact
    chunks dropped past the budget, plus the binning's `selection_misses`
    under bin_miss_check. Binning goes through `bin_faces` with
    `bin_approx` as its recall target.
    """
    _check_capacity(capacity)
    binned = bin_faces(face_verts, image_size, capacity, bin_approx,
                       with_misses=bin_miss_check)
    bins, counts = binned[:2]
    kept, overflow = _windows(counts, compact)
    if bin_miss_check:
        overflow = overflow + binned[2]
    D = attributes.shape[-1]
    tx = -(-image_size // TILE_COLS)
    p2f, zbuf, slots, vals = raster_planes_windows(
        kept, bins, planes_records(face_verts, attributes), face_verts.contiguous(),
        image_size, tx, D)
    vals = torch.stack([_tiles_to_image(v, image_size) for v in vals], dim=-1)
    return (vals, _tiles_to_image(p2f, image_size), _tiles_to_image(zbuf, image_size),
            slots, bins, overflow)


def _pixelwise_interp(fv_px, attr_px, mask, image_size: int):
    """Barycentric interpolation of per-pixel gathered faces: fv_px
    (B,H,W,3,3), attr_px (B,H,W,3,D), mask (B,H,W,1) -> (B,H,W,D). The
    barycentrics are signed sub-areas relative to the pixel centre over
    twice the face's area (the JAX package's `_edge_terms`)."""
    S = image_size
    c = _ndc(torch.arange(S, device=fv_px.device), S)
    xs, ys = c[None, None, :], c[None, :, None]  # (1,1,W), (1,H,1)
    x0, y0 = fv_px[..., 0, 0], fv_px[..., 0, 1]
    x1, y1 = fv_px[..., 1, 0], fv_px[..., 1, 1]
    x2, y2 = fv_px[..., 2, 0], fv_px[..., 2, 1]
    e0 = (x1 - xs) * (y2 - ys) - (y1 - ys) * (x2 - xs)
    e1 = (x2 - xs) * (y0 - ys) - (y2 - ys) * (x0 - xs)
    e2 = (x0 - xs) * (y1 - ys) - (y0 - ys) * (x1 - xs)
    denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    safe = torch.where(denom.abs() < AREA_EPS, 1.0, denom)
    bary = torch.stack([e0 / safe, e1 / safe, e2 / safe], dim=-1)
    vals = torch.einsum("bhwc,bhwcd->bhwd", bary, attr_px)
    return torch.where(mask, vals, 0.0)


def interpolate_attributes(pix_to_face, face_verts, attributes):
    """Gather-based differentiable interpolation (the JAX package's
    `interpolate_attributes`): pix_to_face (B,H,W) int, face_verts
    (B,F,3,3), attributes (B,F,3,D) -> (vals (B,H,W,D), mask (B,H,W,1)).
    Autograd differentiates it through per-pixel gathers; it is the dense
    reference the rasters' gradients are checked against, and the forward
    of `interpolate_attributes_fast`."""
    B, H, W = pix_to_face.shape
    fid = pix_to_face.clamp_min(0).long()
    mask = (pix_to_face >= 0)[..., None]
    b = torch.arange(B, device=face_verts.device)[:, None, None]
    vals = _pixelwise_interp(face_verts[b, fid], attributes[b, fid], mask, H)
    return vals, mask.to(vals.dtype)


def dense_gradient_and_scale(pix_to_face, face_verts, attributes, g,
                             weighted: bool = True):
    """The rasters' gradient by another road, with its rounding scale.

    -> (d_fv, scale_fv, d_attr, scale_attr): d sum(vals * g) /
    d(face_verts, attributes) by autograd through per-pixel gathers of the
    faces in pix_to_face (`_pixelwise_interp`, the JAX package's
    interpolate_attributes), and per element the sum over the pixels the
    face won of kappa^2 |per-pixel term| (float64), kappa the pixel's edge
    condition number: the sum of |a x|, |b y|, |x_j y_k| and |y_j x_k| over
    the three edges, over |2 area|. The planes raster evaluates edge and
    attribute planes in absolute coordinates and its gradient
    differentiates 1/area, so fp32 rounding is amplified by kappa twice;
    two fp32 evaluations of the gradient that sum n pixel terms in
    different orders agree to about n u times this scale. weighted=False
    drops kappa^2: the scale of a gradient that sums these same per-pixel
    terms in another order (`interpolate_attributes_fast`'s). For checks
    only: nothing on the port's paths calls it."""
    B, F = face_verts.shape[:2]
    S = pix_to_face.shape[1]
    dev = face_verts.device
    fid = pix_to_face.clamp_min(0).long()
    mask = (pix_to_face >= 0)[..., None]
    b = torch.arange(B, device=dev)[:, None, None]
    with torch.enable_grad():
        fv_px = face_verts[b, fid].detach().requires_grad_(True)
        at_px = attributes[b, fid].detach().requires_grad_(True)
        vals = _pixelwise_interp(fv_px, at_px, mask, S)
        d_fv, d_at = torch.autograd.grad((vals * g).sum(), (fv_px, at_px))
    with torch.no_grad():
        c = (2 * torch.arange(S, device=dev, dtype=torch.float64) + 1 - S) / S
        x, y = c[None, None, :], c[None, :, None]
        X, Y = fv_px[..., 0].double(), fv_px[..., 1].double()
        terms = 0.0
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            terms = terms + ((Y[..., j] - Y[..., k]) * x).abs() + \
                ((X[..., k] - X[..., j]) * y).abs() + (X[..., j] * Y[..., k]).abs() + \
                (Y[..., j] * X[..., k]).abs()
        area2 = ((X[..., 1] - X[..., 0]) * (Y[..., 2] - Y[..., 0])
                 - (Y[..., 1] - Y[..., 0]) * (X[..., 2] - X[..., 0])).abs()
        kappa2 = (terms / area2.clamp_min(1e-30)) ** 2 if weighted else 1.0
        k2 = torch.where(mask[..., 0], kappa2, 0.0)
        k2 = k2[..., None, None]
        idx = (b * F + fid).reshape(-1)

        def fold(t):
            out = torch.zeros((B * F,) + t.shape[3:], dtype=t.dtype, device=dev)
            out.index_add_(0, idx, t.reshape((-1,) + t.shape[3:]))
            return out.reshape((B, F) + t.shape[3:])

        return (fold(d_fv), fold(k2 * d_fv.double().abs()),
                fold(d_at), fold(k2 * d_at.double().abs()))


class _RasterizePlanesDiff(torch.autograd.Function):
    """Forward `_v5_impl` (K3); backward image_to_tiles -> K4 with its fold
    epilogue (`segment_moments_to_faces`: the moments folded straight into
    faces) in the "matmul" fold mode, else K4's store (`segment_moments`)
    and `fold_slots_to_faces` in the mode set (`set_fold_mode`) -> the
    vector-Jacobian product of attr_planes. The cotangent of an affine
    plane is its first moments over the pixels it won, so the backward
    gathers nothing per pixel. Coverage is not differentiable: the
    gradient reaches the vertices through the planes only, and the
    gradient to z is zero."""

    @staticmethod
    def forward(ctx, face_verts, attributes, image_size, capacity, compact,
                bin_approx, bin_miss_check):
        vals, p2f, _, slots, bins, overflow = _v5_impl(
            face_verts.detach(), attributes.detach(), image_size, capacity, compact,
            bin_approx=bin_approx, bin_miss_check=bin_miss_check)
        mask = (p2f >= 0)[..., None].to(vals.dtype)
        ctx.mark_non_differentiable(mask, p2f, overflow)
        ctx.save_for_backward(face_verts, attributes, slots, bins)
        ctx.image_size = image_size
        ctx.capacity = capacity
        return vals, mask, p2f, overflow

    @staticmethod
    def backward(ctx, g_vals, _g_mask, _g_p2f, _g_overflow):
        face_verts, attributes, slots, bins = ctx.saved_tensors
        if g_vals is None:
            return (None,) * 7
        g_t = image_to_tiles(g_vals, ctx.image_size).contiguous()
        F = face_verts.shape[1]
        if _FOLD_MODE == "matmul":
            plane_ct = segment_moments_to_faces(slots, g_t, bins, ctx.capacity,
                                                ctx.image_size, F)
        else:
            plane_ct = fold_slots_to_faces(
                segment_moments(slots, g_t, ctx.capacity, ctx.image_size), bins, F)
        with torch.enable_grad():
            fv = face_verts.detach().requires_grad_(True)
            at = attributes.detach().requires_grad_(True)
            dfv, dat = torch.autograd.grad(attr_planes(fv, at), (fv, at), plane_ct)
        needs = ctx.needs_input_grad
        return (dfv if needs[0] else None, dat if needs[1] else None,
                None, None, None, None, None)


def rasterize_planes_diff(face_verts, attributes, image_size: int,
                          capacity: int, *, compact: Optional[int] = None,
                          bin_approx: Optional[float] = None,
                          bin_miss_check: bool = False):
    """Fused differentiable raster -> (vals (B,H,W,D), mask (B,H,W,1),
    pix_to_face (B,H,W) int32, overflow (B,) int32). Value- and
    gradient-equivalent to coverage + barycentric interpolation of the
    corner attributes; mask, pix_to_face and overflow carry no gradient.
    overflow > 0 means trailing tiles rendered EMPTY and carry no
    gradients. bin_approx / bin_miss_check: `_v5_impl`'s (the misses
    added to overflow). The arguments after capacity are keyword-only:
    the JAX package's fifth is `interpret`."""
    return _RasterizePlanesDiff.apply(face_verts, attributes, image_size,
                                      capacity, compact, bin_approx, bin_miss_check)


# ---------------------------------------------------------------------------
# Coverage entry points and the raster for any D (K6 forward, K7 + K5 backward)
# ---------------------------------------------------------------------------


def rasterize_coverage_jnp(face_verts: torch.Tensor, image_size: int,
                           row_chunk: int = 16):
    """All-pairs pixel/triangle z-buffer in plain PyTorch (the name is the
    JAX package's, so that an import line carries over): every pixel tests
    every face with the cross-product edge terms, w = e / area and z = w0*z0
    + w1*z1 + w2*z2; the first minimum in face order wins ties. Chunked by
    rows, at most `row_chunk` and fewer where the (B, rows, W, F)
    intermediates would pass _PLAIN_BLOCK_ELEMS elements. face_verts
    (B,F,3,3) -> (pix_to_face (B,H,W) int32 (-1 empty), zbuf (B,H,W) f32
    (1e10 empty))."""
    B, F = face_verts.shape[:2]
    S = image_size
    dev = face_verts.device
    c = _ndc(torch.arange(S, device=dev), S)
    fv = face_verts.detach()[:, None, None]  # (B,1,1,F,3,3)
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]
    denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    real = denom.abs() >= AREA_EPS
    safe = torch.where(real, denom, 1.0)
    xs = c[None, None, :, None]  # (1,1,W,1)
    rows = max(1, min(row_chunk, _PLAIN_BLOCK_ELEMS // max(1, B * S * F)))
    p2f, zbuf = [], []
    for r0 in range(0, S, rows):
        ys = c[r0:r0 + rows][None, :, None, None]  # (1,rc,1,1)
        w0 = ((x1 - xs) * (y2 - ys) - (y1 - ys) * (x2 - xs)) / safe
        w1 = ((x2 - xs) * (y0 - ys) - (y2 - ys) * (x0 - xs)) / safe
        w2 = ((x0 - xs) * (y1 - ys) - (y0 - ys) * (x1 - xs)) / safe
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & real
        z = torch.where(inside, w0 * z0 + w1 * z1 + w2 * z2, BIG_Z)  # (B,rc,W,F)
        bz, best = z.min(dim=-1)  # first minimum on ties
        p2f.append(torch.where(bz >= BIG_Z, -1, best).to(torch.int32))
        zbuf.append(bz)
    return torch.cat(p2f, dim=1), torch.cat(zbuf, dim=1)


def rasterize_coverage_pallas(face_verts: torch.Tensor, image_size: int,
                              capacity: int = 512):
    """Tiled coverage, one face at a time (K8, `raster_bins_coverage`):
    `bin_faces`, then each tile walks its first `count` faces in bin order.
    The tile grid pads W to a multiple of 128; the result is cropped. ->
    (pix_to_face (B,H,W) int32, zbuf (B,H,W))."""
    B, F = face_verts.shape[:2]
    bins, counts = bin_faces(face_verts.detach(), image_size, capacity)
    fv9 = face_verts.detach().reshape(B, F, 9).contiguous()
    p2f, zbuf = raster_bins_coverage(counts, bins, fv9, image_size)
    return p2f[:, :image_size, :image_size], zbuf[:, :image_size, :image_size]


def _v3_impl(face_verts: torch.Tensor, image_size: int, capacity: int):
    """Tiled coverage on the padded layout (K6) -> (pix_to_face (B,H,W),
    zbuf (B,H,W), pix_to_slot (B,H,W) int32, the winner's index into its
    tile's bin (-1 empty), bins (B,Tp,C) with Tp the 8-padded tile count).
    Each tile walks ceil(count / 32) chunks of its bin, the records read
    through the bins (no gathered record list)."""
    _check_capacity(capacity)
    face_verts = face_verts.detach().contiguous()
    bins, counts = bin_faces(face_verts, image_size, capacity)
    p2f, zbuf, slot = raster_coverage_windows(
        _windows(counts, None)[0], bins, coverage_records(face_verts), face_verts,
        image_size, -(-image_size // TILE_COLS))
    return (_tiles_to_image(p2f, image_size), _tiles_to_image(zbuf, image_size),
            _tiles_to_image(slot, image_size), bins)


def rasterize_coverage_pallas_v3(face_verts: torch.Tensor, image_size: int,
                                 capacity: int = 192):
    """Tiled coverage on the padded layout (K6) -> (pix_to_face, zbuf)."""
    return _v3_impl(face_verts, image_size, capacity)[:2]


def rasterize_coverage_pallas_v3_full(face_verts: torch.Tensor, image_size: int,
                                      capacity: int = 192):
    """-> (pix_to_face, zbuf, pix_to_slot, bins), as `_v3_impl`."""
    return _v3_impl(face_verts, image_size, capacity)


def rasterize_coverage(face_verts: torch.Tensor, image_size: int,
                       capacity: int = 512):
    """Coverage dispatch on the tensors' device, as the JAX package's on
    its backend: K6 (`rasterize_coverage_pallas_v3`) on the card, the
    all-pairs `rasterize_coverage_jnp` on the CPU."""
    if face_verts.device.type == "cuda":
        return rasterize_coverage_pallas_v3(face_verts, image_size, capacity)
    return rasterize_coverage_jnp(face_verts, image_size)


class _InterpolateAttributesFast(torch.autograd.Function):
    """Forward `interpolate_attributes`; backward: the per-pixel gathers and
    the vector-Jacobian product of `_pixelwise_interp`, the per-pixel rows
    [d face_verts (9) | d attributes (3D)] tile-major, K7 sums them per
    (tile, slot) and K5 folds the slots into faces."""

    @staticmethod
    def forward(ctx, face_verts, attributes, pix_to_face, pix_to_slot, bins,
                image_size, capacity):
        vals, mask = interpolate_attributes(pix_to_face, face_verts, attributes)
        ctx.mark_non_differentiable(mask)
        ctx.save_for_backward(face_verts, attributes, pix_to_face, pix_to_slot, bins)
        ctx.image_size = image_size
        ctx.capacity = capacity
        return vals, mask

    @staticmethod
    def backward(ctx, g_vals, _g_mask):
        face_verts, attributes, p2f, p2slot, bins = ctx.saved_tensors
        if g_vals is None:
            return (None,) * 7
        B, H, W = p2f.shape
        F, D = face_verts.shape[1], attributes.shape[-1]
        fid = p2f.clamp_min(0).long()
        b = torch.arange(B, device=p2f.device)[:, None, None]
        with torch.enable_grad():
            fv_px = face_verts.detach()[b, fid].requires_grad_(True)
            at_px = attributes.detach()[b, fid].requires_grad_(True)
            vals = _pixelwise_interp(fv_px, at_px, (p2f >= 0)[..., None], H)
            dfv_px, dat_px = torch.autograd.grad(vals, (fv_px, at_px), g_vals)
        rows = torch.cat([dfv_px.reshape(B, H, W, 9),
                          dat_px.reshape(B, H, W, 3 * D)], dim=-1)
        per_slot = segment_reduce_tiles(
            image_to_tiles(p2slot, ctx.image_size).contiguous(),
            image_to_tiles(rows, ctx.image_size).contiguous(), ctx.capacity)
        folded = fold_slots_to_faces(per_slot, bins, F)
        return (folded[..., :9].reshape(B, F, 3, 3),
                folded[..., 9:].reshape(B, F, 3, D), None, None, None, None, None)


def interpolate_attributes_fast(face_verts, attributes, pix_to_face, pix_to_slot,
                                bins, image_size: int, capacity: int):
    """`interpolate_attributes` with the same values and gradients, whose
    backward reduces the per-pixel gradients per (tile, bin slot) (K7) and
    folds them into faces (K5) instead of scattering per pixel.
    pix_to_slot (B,H,W) and bins (B,Tp,C) are K6's (`_v3_impl`) -> (vals
    (B,H,W,D), mask (B,H,W,1))."""
    return _InterpolateAttributesFast.apply(
        face_verts, attributes, pix_to_face, pix_to_slot, bins, image_size, capacity)


def rasterize(face_verts, attributes, image_size: int, capacity: int = 512, *,
              compact: Optional[int] = None, bin_approx: Optional[float] = None,
              bin_miss_check: bool = False):
    """Full differentiable raster (the JAX package's `rasterize` on its
    Pallas path) -> (vals (B,H,W,D), mask (B,H,W,1), pix_to_face (B,H,W)
    int32, overflow (B,) int32). D attribute channels with 13 + 3D <= 32
    (D <= 6) take the planes raster (`rasterize_planes_diff`, K3 + K4's
    fold, on the `compact` layout, binned with `bin_approx`, its misses
    added to overflow under `bin_miss_check`); wider attributes take the
    coverage raster K6 and `interpolate_attributes_fast` (K7 + K5), which
    bins the padded layout with the module's mode, so `compact`,
    `bin_approx` and `bin_miss_check` do not apply and overflow is 0.
    Coverage carries no gradient."""
    D = attributes.shape[-1]
    if 13 + 3 * D <= REC5_LANES:
        return rasterize_planes_diff(face_verts, attributes, image_size, capacity,
                                     compact=compact, bin_approx=bin_approx,
                                     bin_miss_check=bin_miss_check)
    p2f, _, p2slot, bins = rasterize_coverage_pallas_v3_full(
        face_verts, image_size, capacity)
    vals, mask = interpolate_attributes_fast(
        face_verts, attributes, p2f, p2slot, bins, image_size, capacity)
    overflow = torch.zeros((face_verts.shape[0],), dtype=torch.int32,
                           device=face_verts.device)
    return vals, mask, p2f, overflow
