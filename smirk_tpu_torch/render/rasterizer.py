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
1. `bin_faces_flat`: bounding-box overlap of every face with every 8x128
   pixel tile, then an exact top-k per tile keeps the `capacity` nearest
   overlapping faces (near-to-far priority: a 255-bucket mean z, then the
   face id). Bins are -1 padded; the tile count is padded to a multiple of 8.
2. `face_records_shaded`: one 32-lane record per face with its three
   sign-normalized edge functions, its depth plane and its three normal
   planes, all affine in the pixel centre.
3. Compact layout (`compact` set): `_compact_plan` turns per-tile counts
   into chunk windows over one list of occupied 32-face chunks per image,
   clipped to the budget; `compact_faces` (kernel K2) packs the chunks.
   Padded layout (`compact=None`): each tile walks its own padded bin.
4. `raster_fused_windows` (kernel K1): per tile, walk the chunk window,
   keep the nearest covering face (first in slot order on ties), and
   evaluate its normal planes at the pixel.

The coverage rasters: `rasterize_coverage_jnp` (all pairs, plain
PyTorch), `rasterize_coverage_pallas_v3[_full]` (`face_records` on the
padded layout, `raster_coverage_windows`, kernel K6: pix_to_face, zbuf and
the per-tile slot) and `rasterize_coverage_pallas` (`raster_bins_coverage`,
kernel K8: one face at a time per tile, division barycentrics).
`rasterize_coverage` takes K6 on the card and the all-pairs version on the
CPU.

The differentiable raster (`rasterize`). For D <= 6 attribute channels,
`rasterize_planes_diff`, a torch.autograd.Function, bins, plans and packs
the same way, with a training record per face (edge and depth planes, the
face id, D attribute planes). Forward: `raster_planes_windows` (K3) keeps
the nearest face, its per-tile slot and its D interpolated planes.
Backward: the value cotangent goes tile-major, `segment_moments` (K4)
sums [g*x | g*y | g] per (tile, slot), `fold_slots_to_faces` (K5) folds
the slots into faces, and autograd of `attr_planes` takes it to the
vertices and attributes. For D > 6, K6 gives the coverage and
`interpolate_attributes_fast` interpolates by per-pixel gathers; its
backward reduces the per-pixel gradients per (tile, slot) with
`segment_reduce_tiles` (K7) and folds them into faces with K5.

K1-K8 are CUDA kernels (csrc/). Each wrapper checks its arguments,
launches on PyTorch's current stream and counts its launches; for tensors
on the CPU it runs the plain PyTorch version beside it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from smirk_tpu_torch import kernels

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


def _bbox_and_priority(face_verts: torch.Tensor, image_size: int):
    """Pixel-space bboxes + unique near-to-far priority per face.

    Priority = 255-bucket quantized mean z, then face id, so that ties keep
    first-face-wins order within a bucket."""
    H = W = image_size
    F = face_verts.shape[1]
    x = face_verts[..., 0]
    y = face_verts[..., 1]
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
    return xmin, xmax, ymin, ymax, prio, (NB + 2) * F


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


def bin_faces_flat(
    face_verts: torch.Tensor, image_size: int, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign triangles to pixel tiles by bounding box.

    -> (bins (B,Tp,C) int32 -1 padded, counts (B,Tp) int32), where
    T = ceil(H/8) * ceil(W/128) and Tp rounds T up to a multiple of 8.
    Each tile keeps its `capacity` nearest overlapping faces, nearest
    first: an exact top-k over the integer key overlap * prio_span - prio,
    so a tile's count is min(overlapping faces, capacity) and no face is
    missed (the JAX package's approximate top-k needs a miss count).
    """
    B, F = face_verts.shape[:2]
    H = W = image_size
    ty = -(-H // TILE_ROWS)
    tx = -(-W // TILE_COLS)
    T = ty * tx
    xmin, xmax, ymin, ymax, prio, prio_span = _bbox_and_priority(
        face_verts, image_size)
    dev = face_verts.device
    tile_r0 = (torch.arange(ty, device=dev) * TILE_ROWS).to(torch.float32)
    tile_c0 = (torch.arange(tx, device=dev) * TILE_COLS).to(torch.float32)
    # overlap iff bbox intersects the tile's pixel-centre range
    ov_r = (ymax[:, None, :] >= tile_r0[None, :, None]) & (
        ymin[:, None, :] <= tile_r0[None, :, None] + TILE_ROWS - 1)  # (B,ty,F)
    ov_c = (xmax[:, None, :] >= tile_c0[None, :, None]) & (
        xmin[:, None, :] <= tile_c0[None, :, None] + TILE_COLS - 1)  # (B,tx,F)
    overlap = (ov_r[:, :, None, :] & ov_c[:, None, :, :]).reshape(B, T, F)

    k = min(capacity, F)
    key = overlap.to(torch.int32) * prio_span - prio[:, None, :]
    vals, idx = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    valid = vals > 0
    bins = torch.where(valid, idx.to(torch.int32), -1)
    counts = valid.sum(-1, dtype=torch.int32)  # (B,T)
    return _pad_bins(bins, counts, capacity, k, T)


_OTHER_BINNING = ("the port bins exactly with bin_faces_flat; the JAX package's "
                  "approximate, hierarchical and sorted binning are not ported "
                  "(ROADMAP.md, Queue 2)")


def set_bin_mode(hier: bool, approx: Optional[float] = None,
                 sorted_: bool = False) -> None:
    """The JAX package's binning switch. Only the exact flat mode (False,
    None, False) exists here; the others raise NotImplementedError."""
    if hier or approx is not None or sorted_:
        raise NotImplementedError(_OTHER_BINNING)


def bin_faces(face_verts: torch.Tensor, image_size: int, capacity: int,
              approx: Optional[float] = None, with_misses: bool = False):
    """The JAX package's binning dispatch: exact flat binning
    (`bin_faces_flat`) -> (bins, counts[, misses (B,) int32]). An exact
    top-k misses no overlapping face, so `with_misses` appends zeros;
    `approx` raises NotImplementedError."""
    if approx is not None:
        raise NotImplementedError(_OTHER_BINNING)
    bins, counts = bin_faces_flat(face_verts, image_size, capacity)
    if with_misses:
        misses = torch.zeros((bins.shape[0],), dtype=torch.int32, device=bins.device)
        return bins, counts, misses
    return bins, counts


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
    kill[2] = -1.0
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


def face_records_shaded(
    face_verts: torch.Tensor, face_normals: torch.Tensor
) -> torch.Tensor:
    """(B,F,3,3) verts + (B,F,3,3) corner normals -> (B,F,32) records.

    Lanes 0-12 as face_records (lane 12 = face id, set by the caller);
    lanes 16-24 hold the affine normal planes
    [NAx NAy NAz | NBx NBy NBz | NCx NCy NCz].
    """
    base = face_records(face_verts)
    nplane = attr_planes(face_verts, face_normals)
    pad = face_verts.new_zeros(face_verts.shape[:-2] + (7,))
    return torch.cat([base, nplane, pad], dim=-1)


def _gather_recs(records: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """records (B,F,L), ids (B,N) int (-1 = empty) -> (B,N,L). Empty slots
    read a kill row (edge c0 = -1, fid = -1) appended at index F."""
    B, F, L = records.shape
    kill = records.new_zeros((L,))
    kill[2] = -1.0
    kill[12] = -1.0
    ext = torch.cat([records, kill.expand(B, 1, L)], dim=1)
    idx = torch.where(ids < 0, F, ids).long()
    b = torch.arange(B, device=records.device)[:, None]
    return ext[b, idx]


def _compact_plan(counts: torch.Tensor, cmax: int):
    """Chunk windows + chunk->tile map for the compact layout.

    counts (B,Tp) -> (starts, ends, tof, total, dropped): starts/ends
    (B,Tp) int32 chunk windows clipped to cmax; tof (B,cmax) tile of each
    compact chunk; total (B,) int32 occupied chunks kept; dropped (B,)
    int32 occupied chunks beyond the budget. dropped > 0 means trailing
    tiles were clipped to EMPTY windows; the renderer reports it as
    `raster_overflow`.
    """
    B, Tp = counts.shape
    CH = V3_CHUNK
    cc = (counts + (CH - 1)) // CH
    ends = torch.cumsum(cc, dim=1, dtype=torch.int32)
    starts = ends - cc
    dropped = (ends[:, -1] - cmax).clamp_min(0).to(torch.int32)
    total = ends[:, -1].clamp(max=cmax).to(torch.int32)
    c_ids = torch.arange(cmax, dtype=torch.int32, device=counts.device)
    tof = torch.searchsorted(ends, c_ids[None].expand(B, cmax).contiguous(),
                             right=True)
    tof = tof.clamp(max=Tp - 1).to(torch.int32)
    return (
        starts.clamp(max=cmax).to(torch.int32),
        ends.clamp(max=cmax).to(torch.int32),
        tof,
        total,
        dropped,
    )


# ---------------------------------------------------------------------------
# K2: chunk compaction
# ---------------------------------------------------------------------------


def compact_faces_plain(tof, starts, total, bins, cpt: int) -> torch.Tensor:
    """Plain version of K2. bins (B, Tp*cpt, 32) int32: tile t's chunk k is
    row t*cpt + k. -> (B, cmax, 32) int32: row c < total[b] is the chunk
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


def compact_faces(tof, starts, total, bins, cpt: int) -> torch.Tensor:
    """K2: pack each image's occupied 32-face chunks into one list.

    Replaces `_compact_faces_kernel` (smirk_tpu/render/rasterizer.py).
    Bound on H100: bytes; a few MB, so launch latency dominates. Design:
    one block per image, consecutive threads copy consecutive ids of a
    row, so loads and stores coalesce. CPU tensors take the plain version.
    """
    if bins.device.type == "cpu":
        return compact_faces_plain(tof, starts, total, bins, cpt)
    if bins.device.type != "cuda":
        raise ValueError(f"compact_faces: unsupported device {bins.device}")
    dev = bins.device
    B, cmax = tof.shape
    Tp = starts.shape[1]
    _check_cuda("tof", tof, torch.int32, 2, dev)
    _check_cuda("starts", starts, torch.int32, 2, dev)
    _check_cuda("total", total, torch.int32, 1, dev)
    _check_cuda("bins", bins, torch.int32, 3, dev)
    if (starts.shape[0] != B or total.shape[0] != B
            or tuple(bins.shape) != (B, Tp * cpt, V3_CHUNK)):
        raise ValueError("compact_faces: inconsistent shapes "
                         f"tof {tuple(tof.shape)} starts {tuple(starts.shape)} "
                         f"total {tuple(total.shape)} bins {tuple(bins.shape)}")
    out = torch.empty((B, cmax, V3_CHUNK), dtype=torch.int32, device=dev)
    lib = kernels.library("compact_faces")
    rc = lib.smirk_compact_faces(
        tof.data_ptr(), starts.data_ptr(), total.data_ptr(), bins.data_ptr(),
        out.data_ptr(), B, Tp, cpt, cmax, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "compact_faces")
    compact_faces.launches += 1
    return out


compact_faces.launches = 0


# ---------------------------------------------------------------------------
# K1: fused z-buffer + normal planes over per-tile chunk windows
# ---------------------------------------------------------------------------


def _tile_centers(Tp: int, image_size: int, tiles_x: int, device):
    """(Tp, 1024) NDC x and y of every pixel of every tile, row-major in
    the 8x128 tile."""
    pix = torch.arange(TILE_PIX, device=device)
    t = torch.arange(Tp, device=device)
    col = pix[None] % TILE_COLS + (t % tiles_x)[:, None] * TILE_COLS
    row = pix[None] // TILE_COLS + (t // tiles_x)[:, None] * TILE_ROWS
    return _ndc(col, image_size), _ndc(row, image_size)


def _affine(rec, ia, ib, ic, xs, ys):
    return rec[..., ia] * xs + rec[..., ib] * ys + rec[..., ic]


def _plain_zbuffer(starts, ends, recs, image_size: int, tiles_x: int):
    """The chunk walk shared by the plain versions of K1 and K3.

    starts/ends (B,Tp) int32: tile t walks chunks [starts, ends) of its
    image's record list recs (B, N*32, L) f32. Within a chunk the nearest
    inside face wins, first slot on ties; a later chunk replaces the winner
    only if strictly nearer. Yields, per group of images (bounded so that
    no intermediate exceeds _PLAIN_BLOCK_ELEMS elements): (bidx (G,1)
    image ids, bz (G,Tp,P) nearest depth (1e10 empty), win (G,Tp,P) the
    winner's index in its image's record list, x, y (1,Tp,P) pixel
    centres).
    """
    B, Tp = starts.shape
    dev = recs.device
    CH, L = V3_CHUNK, recs.shape[-1]
    chunks = recs.reshape(B, -1, CH, L)
    xs, ys = _tile_centers(Tp, image_size, tiles_x, dev)
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
            c = s + j
            active = c < e
            rec = chunks[bidx, torch.where(active, c, 0)]  # (G,Tp,CH,L)
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


def raster_fused_windows_plain(starts, ends, recs, image_size: int, tiles_x: int):
    """Plain version of K1: `_plain_zbuffer` over records in the
    RECF_LANES layout. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf (1e10
    empty), nx, ny, nz (0 empty), all f32 but p2f.
    """
    outs = []
    for bidx, bz, win, x, y in _plain_zbuffer(starts, ends, recs, image_size, tiles_x):
        covered = bz < BIG_Z
        wrec = recs[bidx[:, :, None], win]  # (G,Tp,P,L)
        planes = [_affine(wrec, 16 + d, 19 + d, 22 + d, x, y) for d in range(3)]
        outs.append((
            torch.where(covered, wrec[..., 12].to(torch.int32), -1),
            torch.where(covered, bz, BIG_Z),
            *[torch.where(covered, n, 0.0) for n in planes],
        ))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def raster_fused_windows(starts, ends, recs, image_size: int, tiles_x: int):
    """K1: per-tile z-buffer over chunk windows + the winner's normals.

    Replaces `_raster_kernel_v7` (compact record list) and, fed the padded
    layout, `_raster_kernel_v4` (smirk_tpu/render/rasterizer.py). Bound on
    H100: fp32 operations (~16 per face-pixel test; the records are 4 KB
    per chunk and stay in L2/shared memory). Design: one block per (tile,
    image), 256 threads x 4 pixels; each chunk's 32 records are staged in
    shared memory and read as broadcasts, so every record value loaded
    feeds four pixels. CPU tensors take the plain version.
    """
    if recs.device.type == "cpu":
        return raster_fused_windows_plain(starts, ends, recs, image_size, tiles_x)
    if recs.device.type != "cuda":
        raise ValueError(f"raster_fused_windows: unsupported device {recs.device}")
    dev = recs.device
    B, Tp = starts.shape
    _check_cuda("starts", starts, torch.int32, 2, dev)
    _check_cuda("ends", ends, torch.int32, 2, dev)
    _check_cuda("recs", recs, torch.float32, 3, dev)
    if (tuple(ends.shape) != (B, Tp) or recs.shape[0] != B
            or recs.shape[2] != RECF_LANES or recs.shape[1] % V3_CHUNK):
        raise ValueError("raster_fused_windows: inconsistent shapes "
                         f"starts {tuple(starts.shape)} ends {tuple(ends.shape)} "
                         f"recs {tuple(recs.shape)}")
    if recs.data_ptr() % 16:
        raise ValueError("raster_fused_windows: recs must be 16-byte aligned")
    n_chunks = recs.shape[1] // V3_CHUNK
    p2f = torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
    zbuf, nx, ny, nz = (torch.empty((B, Tp, TILE_PIX), dtype=torch.float32,
                                    device=dev) for _ in range(4))
    lib = kernels.library("raster_fused")
    rc = lib.smirk_raster_fused_windows(
        starts.data_ptr(), ends.data_ptr(), recs.data_ptr(), p2f.data_ptr(),
        zbuf.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
        B, Tp, n_chunks, image_size, image_size, tiles_x, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_fused_windows")
    raster_fused_windows.launches += 1
    return p2f, zbuf, nx, ny, nz


raster_fused_windows.launches = 0


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


def _layout(records, bins, counts, capacity: int, compact: Optional[int]):
    """Chunk windows and the record list the window rasters walk -> (starts,
    ends (B,Tp) int32, recs (B, N*32, L) contiguous, overflow (B,) int32).

    compact: chunk budget of the compact layout (rounded up to 8: the plan,
    K2 and a gather of the packed chunks); None = the padded layout, tile t
    walking its own bin. Empty slots gather a kill row; overflow counts the
    compact chunks dropped past the budget (0 on the padded layout)."""
    B, Tp = counts.shape
    CPT = capacity // V3_CHUNK
    if compact is None:
        starts, ends = padded_windows(counts, CPT)
        faces = bins.reshape(B, Tp * capacity)
        overflow = torch.zeros((B,), dtype=torch.int32, device=counts.device)
    else:
        compact = -(-compact // 8) * 8
        starts, ends, tof, total, overflow = _compact_plan(counts, compact)
        faces = compact_faces(tof, starts, total,
                              bins.reshape(B, Tp * CPT, V3_CHUNK), CPT)
        faces = faces.reshape(B, compact * V3_CHUNK)
    return starts, ends, _gather_recs(records, faces).contiguous(), overflow


# ---------------------------------------------------------------------------
# Fused inference raster
# ---------------------------------------------------------------------------


def rasterize_normals_fused(
    face_verts: torch.Tensor,
    face_normals: torch.Tensor,
    image_size: int,
    capacity: int = 640,
    compact: Optional[int] = None,
    return_overflow: bool = False,
):
    """Fused inference raster -> (normal image (B,H,W,3), pix_to_face
    (B,H,W) int32, zbuf (B,H,W)[, overflow (B,) int32]).

    compact: chunk budget of the compact layout (rounded up to 8); None =
    padded layout, each tile walking its own bin. overflow counts compact
    chunks dropped past the budget (0 on the padded layout).
    """
    _check_capacity(capacity)
    bins, counts = bin_faces_flat(face_verts, image_size, capacity)
    starts, ends, recs, overflow = _layout(
        fused_records(face_verts, face_normals), bins, counts, capacity, compact)
    outs = raster_fused_windows(starts, ends, recs, image_size,
                                -(-image_size // TILE_COLS))
    p2f = _tiles_to_image(outs[0], image_size)
    zbuf = _tiles_to_image(outs[1], image_size)
    normals = torch.stack([_tiles_to_image(o, image_size) for o in outs[2:5]], dim=-1)
    if return_overflow:
        return normals, p2f, zbuf, overflow
    return normals, p2f, zbuf


# ---------------------------------------------------------------------------
# The differentiable raster (training): K3 forward, K4 + K5 backward
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


def raster_planes_windows_plain(starts, ends, recs, image_size: int,
                                tiles_x: int, D: int):
    """Plain version of K3: `_plain_zbuffer` over records in the
    REC5_LANES layout. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf f32 (1e10
    empty), slot (B,Tp,1024) int32, the winner's per-tile slot
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


def raster_planes_windows(starts, ends, recs, image_size: int, tiles_x: int, D: int):
    """K3: per-tile z-buffer over chunk windows + the winner's per-tile slot
    and D attribute planes (the differentiable raster's forward).

    Replaces `_raster_kernel_v5c` (compact record list) and, fed the padded
    layout, `_raster_kernel_v5` (smirk_tpu/render/rasterizer.py). Bound on
    H100: fp32 operations (~16 per face-pixel test), with FMAs forbidden so
    that it stays bitwise equal to the plain version. Design: K1's, one
    block per (tile, image), 256 threads x 4 pixels, each chunk's 32
    records staged in shared memory and read as broadcasts; the slot and
    the D planes of the winner are evaluated once, at the end. CPU tensors
    take the plain version. -> as `raster_planes_windows_plain`.
    """
    if recs.device.type == "cpu":
        return raster_planes_windows_plain(starts, ends, recs, image_size, tiles_x, D)
    if recs.device.type != "cuda":
        raise ValueError(f"raster_planes_windows: unsupported device {recs.device}")
    dev = recs.device
    B, Tp = starts.shape
    _check_cuda("starts", starts, torch.int32, 2, dev)
    _check_cuda("ends", ends, torch.int32, 2, dev)
    _check_cuda("recs", recs, torch.float32, 3, dev)
    if (tuple(ends.shape) != (B, Tp) or recs.shape[0] != B
            or recs.shape[2] != REC5_LANES or recs.shape[1] % V3_CHUNK
            or not 1 <= D <= (REC5_LANES - 13) // 3):
        raise ValueError("raster_planes_windows: inconsistent shapes "
                         f"starts {tuple(starts.shape)} ends {tuple(ends.shape)} "
                         f"recs {tuple(recs.shape)} D {D}")
    if recs.data_ptr() % 16:
        raise ValueError("raster_planes_windows: recs must be 16-byte aligned")
    n_chunks = recs.shape[1] // V3_CHUNK
    p2f = torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
    zbuf = torch.empty((B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    slot = torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
    vals = torch.empty((D, B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    lib = kernels.library("raster_planes")
    rc = lib.smirk_raster_planes_windows(
        starts.data_ptr(), ends.data_ptr(), recs.data_ptr(), p2f.data_ptr(),
        zbuf.data_ptr(), slot.data_ptr(), vals.data_ptr(), B, Tp, n_chunks,
        image_size, image_size, tiles_x, D, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
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


def _channel_group(lib, capacity: int, channels: int, device) -> int:
    """Channels per block of a per-(tile, slot) reduction whose capacity x
    channels fp32 accumulators live in shared memory: all of them where
    they fit in the device's opt-in limit per block, else the fewest
    groups of near-equal width that fit."""
    limit = lib.smirk_max_shared_optin(device.index)
    if limit <= 0:
        raise RuntimeError("could not read the device's shared memory limit")
    if capacity * 4 > limit:
        raise ValueError(f"capacity {capacity}: one channel of accumulators "
                         f"exceeds the {limit} bytes of shared memory per block")
    groups = -(-capacity * channels * 4 // limit)
    return -(-channels // groups)


def segment_moments_plain(slots, g, capacity: int, image_size: int):
    """Plain version of K4: the moment rows, then one scatter_add_ into the
    (B, Tp*C) slot rows (-1 slots go to a dropped row). -> (B,Tp,C,3D)."""
    return segment_sum(slots, moment_rows(g, image_size), capacity)


def segment_moments(slots, g, capacity: int, image_size: int):
    """K4: per-(tile, slot) sums of [g*x | g*y | g] over the pixels the slot
    won; slots (B,Tp,1024) int32 (-1 = none), g (B,Tp,1024,D) f32
    tile-major -> (B,Tp,C,3D) f32, zeros for slots that won nothing.

    Replaces `_segment_moments_kernel` (`segment_reduce_moments`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes (slots + g read
    once, the rows written once; ~16 us at b32, 224 px). Design: one block
    per (tile, image) with the tile's C x 3D accumulators in shared memory
    (dynamic, past 48 KB by opt-in; the 3D channels split into groups over
    the grid where even the opt-in limit is too small), shared-memory
    atomics per pixel, one coalesced store; the atomics make the float
    order vary, so it matches the plain version within a tolerance, not
    bitwise. CPU tensors take the plain version.
    """
    if g.device.type == "cpu":
        return segment_moments_plain(slots, g, capacity, image_size)
    if g.device.type != "cuda":
        raise ValueError(f"segment_moments: unsupported device {g.device}")
    dev = g.device
    _check_cuda("slots", slots, torch.int32, 3, dev)
    _check_cuda("g", g, torch.float32, 4, dev)
    B, Tp, P, D = g.shape
    if tuple(slots.shape) != (B, Tp, P) or P != TILE_PIX:
        raise ValueError("segment_moments: inconsistent shapes "
                         f"slots {tuple(slots.shape)} g {tuple(g.shape)}")
    out = torch.empty((B, Tp, capacity, 3 * D), dtype=torch.float32, device=dev)
    lib = kernels.library("segment_moments")
    group = _channel_group(lib, capacity, 3 * D, dev)
    rc = lib.smirk_segment_moments(
        slots.data_ptr(), g.data_ptr(), out.data_ptr(), B, Tp, capacity, D,
        group, image_size, image_size, -(-image_size // TILE_COLS), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "segment_moments")
    segment_moments.launches += 1
    return out


segment_moments.launches = 0


def _fold_index(bins: torch.Tensor, F: int) -> torch.Tensor:
    """bins (B,Tp,C) -> flat (B*Tp*C,) rows b*F + id of a (B*F + 1) table;
    ids outside [0, F) go to the dropped last row."""
    B = bins.shape[0]
    ids = bins.reshape(B, -1).long()
    b = torch.arange(B, device=bins.device)[:, None] * F
    return torch.where((ids >= 0) & (ids < F), b + ids, B * F).reshape(-1)


def fold_slots_to_faces_plain(per_slot, bins, F: int):
    """Plain version of K5: one index_add_ over (B*F) rows. -> (B,F,CHN)."""
    B, Tp, C, CHN = per_slot.shape
    out = per_slot.new_zeros((B * F + 1, CHN))
    out.index_add_(0, _fold_index(bins, F), per_slot.reshape(-1, CHN))
    return out[:B * F].reshape(B, F, CHN)


def fold_slots_to_faces(per_slot, bins, F: int):
    """K5: per-face totals of per-(tile, slot) rows; per_slot (B,Tp,C,CHN)
    f32, bins (B,Tp,C) int32 face ids (< 0 dropped) -> (B,F,CHN) f32.

    Replaces `_fold_kernel` (`_fold_matmul` / `fold_slots_to_faces`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes (~9.4 us at b32,
    224 px). Design: one thread per element, atomicAdd into the zeroed
    output where the slot holds a face and the value is not 0; a face
    appears once per tile, so its atomics rarely collide. The float order
    varies, so it matches the plain version within a tolerance. CPU tensors
    take the plain version.
    """
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
    out = torch.zeros((B, F, CHN), dtype=torch.float32, device=dev)
    lib = kernels.library("fold_faces")
    rc = lib.smirk_fold_faces(
        per_slot.data_ptr(), bins.data_ptr(), out.data_ptr(), B, Tp * C, CHN, F,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fold_slots_to_faces")
    fold_slots_to_faces.launches += 1
    return out


fold_slots_to_faces.launches = 0

# ---------------------------------------------------------------------------
# The coverage rasters (K6, K8) and the payload reduction (K7)
# ---------------------------------------------------------------------------

REC_LANES = 16  # [a0 b0 c0 a1 b1 c1 a2 b2 c2 zA zB zC fid pad pad pad]


def raster_coverage_windows_plain(starts, ends, recs, image_size: int, tiles_x: int):
    """Plain version of K6: `_plain_zbuffer` over records in the REC_LANES
    layout. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf f32 (1e10 empty),
    slot (B,Tp,1024) int32, the winner's per-tile slot (c - start)*32 +
    best (-1 empty)."""
    outs = [_winner_and_slot(starts, recs, *group[:3])[2:]
            for group in _plain_zbuffer(starts, ends, recs, image_size, tiles_x)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def raster_coverage_windows(starts, ends, recs, image_size: int, tiles_x: int):
    """K6: per-tile coverage z-buffer over chunk windows -> as
    `raster_coverage_windows_plain`.

    Replaces `_raster_kernel_v3` (via `_v3_impl`,
    smirk_tpu/render/rasterizer.py). Bound on H100: fp32 operations (~16
    per face-pixel test over the windows). Design: K3's without the
    attribute planes, one block per (tile, image), 256 threads x 4 pixels,
    each chunk's 32 records (2 KB) staged in shared memory and read as
    broadcasts, the strict first-minimum rule and no FMAs, so it is
    bitwise equal to its plain version and to K3's coverage outputs on the
    same bins. CPU tensors take the plain version.
    """
    if recs.device.type == "cpu":
        return raster_coverage_windows_plain(starts, ends, recs, image_size, tiles_x)
    if recs.device.type != "cuda":
        raise ValueError(f"raster_coverage_windows: unsupported device {recs.device}")
    dev = recs.device
    B, Tp = starts.shape
    _check_cuda("starts", starts, torch.int32, 2, dev)
    _check_cuda("ends", ends, torch.int32, 2, dev)
    _check_cuda("recs", recs, torch.float32, 3, dev)
    if (tuple(ends.shape) != (B, Tp) or recs.shape[0] != B
            or recs.shape[2] != REC_LANES or recs.shape[1] % V3_CHUNK):
        raise ValueError("raster_coverage_windows: inconsistent shapes "
                         f"starts {tuple(starts.shape)} ends {tuple(ends.shape)} "
                         f"recs {tuple(recs.shape)}")
    if recs.data_ptr() % 16:
        raise ValueError("raster_coverage_windows: recs must be 16-byte aligned")
    p2f, slot = (torch.empty((B, Tp, TILE_PIX), dtype=torch.int32, device=dev)
                 for _ in range(2))
    zbuf = torch.empty((B, Tp, TILE_PIX), dtype=torch.float32, device=dev)
    lib = kernels.library("raster_coverage")
    rc = lib.smirk_raster_coverage_windows(
        starts.data_ptr(), ends.data_ptr(), recs.data_ptr(), p2f.data_ptr(),
        zbuf.data_ptr(), slot.data_ptr(), B, Tp, recs.shape[1] // V3_CHUNK,
        image_size, image_size, tiles_x, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_coverage_windows")
    raster_coverage_windows.launches += 1
    return p2f, zbuf, slot


raster_coverage_windows.launches = 0


def segment_reduce_tiles(slots, payload, capacity: int):
    """K7: per-(tile, slot) sums of a per-pixel payload; slots (B,Tp,1024)
    int32 (-1 = none; the tile grid's padding pixels hold slot 0 with a
    zero payload), payload (B,Tp,1024,CHN) f32 tile-major -> (B,Tp,C,CHN)
    f32, zeros for slots that won nothing.

    Replaces `_segment_reduce_kernel` (`segment_reduce_tiles`,
    smirk_tpu/render/rasterizer.py). Bound on H100: bytes (the payload and
    the slots read once, the rows written once). Design: K4's, one block
    per (tile, image) with the tile's C x CHN accumulators in dynamic
    shared memory (past 48 KB by opt-in), CHN split into channel groups
    over the grid where even the opt-in limit is too small; shared-memory
    atomics per (pixel, channel), one coalesced store. The atomics make the
    float order vary, so it matches its plain version, `segment_sum` (one
    scatter_add_), within a tolerance. CPU tensors take the plain version.
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
    out = torch.empty((B, Tp, capacity, CHN), dtype=torch.float32, device=dev)
    lib = kernels.library("segment_reduce")
    group = _channel_group(lib, capacity, CHN, dev)
    rc = lib.smirk_segment_reduce_tiles(
        slots.data_ptr(), payload.data_ptr(), out.data_ptr(), B, Tp, capacity,
        CHN, group, dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
    smirk_tpu/render/rasterizer.py). Bound on H100: fp32 operations (~29
    per face-pixel test: 21 for the edge terms, 3 divisions, 5 for the
    depth, over count x 1024 pairs per tile). Design: one block per (tile,
    image), 256 threads x 4 pixels; 32 bin entries at a time are staged in
    shared memory with each face's area, every operation an IEEE `__f*_rn`
    intrinsic (`__fdiv_rn` for the barycentrics), so it is bitwise equal to
    its plain version. CPU tensors take the plain version.
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
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "raster_bins_coverage")
    raster_bins_coverage.launches += 1
    return p2f, zbuf


raster_bins_coverage.launches = 0

KERNELS = (compact_faces, raster_fused_windows, raster_planes_windows,
           segment_moments, fold_slots_to_faces, raster_coverage_windows,
           segment_reduce_tiles, raster_bins_coverage)


def _v5_impl(face_verts, attributes, image_size: int, capacity: int,
             compact: Optional[int] = None):
    """The differentiable raster's forward on detached inputs -> (vals
    (B,H,W,D), pix_to_face (B,H,W), zbuf (B,H,W), slots (B,Tp,1024)
    tile-major per-tile slots, bins (B,Tp,C), overflow (B,) int32).

    compact: chunk budget of the compact layout (rounded up to 8; the plan,
    K2 and the record gather of the inference raster); None = padded
    layout. overflow counts compact chunks dropped past the budget.
    """
    _check_capacity(capacity)
    bins, counts = bin_faces_flat(face_verts, image_size, capacity)
    starts, ends, recs, overflow = _layout(
        planes_records(face_verts, attributes), bins, counts, capacity, compact)
    D = attributes.shape[-1]
    tx = -(-image_size // TILE_COLS)
    p2f, zbuf, slots, vals = raster_planes_windows(starts, ends, recs, image_size, tx, D)
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
    """Forward `_v5_impl` (K3); backward image_to_tiles -> K4 -> K5 -> the
    vector-Jacobian product of attr_planes. The cotangent of an affine
    plane is its first moments over the pixels it won, so the backward
    gathers nothing per pixel. Coverage is not differentiable: the
    gradient reaches the vertices through the planes only, and the
    gradient to z is zero."""

    @staticmethod
    def forward(ctx, face_verts, attributes, image_size, capacity, compact):
        vals, p2f, _, slots, bins, overflow = _v5_impl(
            face_verts.detach(), attributes.detach(), image_size, capacity, compact)
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
            return None, None, None, None, None
        g_t = image_to_tiles(g_vals, ctx.image_size).contiguous()
        per_slot = segment_moments(slots, g_t, ctx.capacity, ctx.image_size)
        plane_ct = fold_slots_to_faces(per_slot, bins, face_verts.shape[1])
        with torch.enable_grad():
            fv = face_verts.detach().requires_grad_(True)
            at = attributes.detach().requires_grad_(True)
            dfv, dat = torch.autograd.grad(attr_planes(fv, at), (fv, at), plane_ct)
        needs = ctx.needs_input_grad
        return (dfv if needs[0] else None, dat if needs[1] else None,
                None, None, None)


def rasterize_planes_diff(face_verts, attributes, image_size: int,
                          capacity: int, compact: Optional[int] = None):
    """Fused differentiable raster -> (vals (B,H,W,D), mask (B,H,W,1),
    pix_to_face (B,H,W) int32, overflow (B,) int32). Value- and
    gradient-equivalent to coverage + barycentric interpolation of the
    corner attributes; mask, pix_to_face and overflow carry no gradient.
    overflow > 0 means trailing tiles rendered EMPTY and carry no
    gradients."""
    return _RasterizePlanesDiff.apply(face_verts, attributes, image_size,
                                      capacity, compact)


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
    Empty slots gather a kill row."""
    _check_capacity(capacity)
    face_verts = face_verts.detach()
    bins, counts = bin_faces(face_verts, image_size, capacity)
    starts, ends, recs, _ = _layout(coverage_records(face_verts), bins, counts,
                                    capacity, None)
    p2f, zbuf, slot = raster_coverage_windows(
        starts, ends, recs, image_size, -(-image_size // TILE_COLS))
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
              compact: Optional[int] = None):
    """Full differentiable raster (the JAX package's `rasterize` on its
    Pallas path) -> (vals (B,H,W,D), mask (B,H,W,1), pix_to_face (B,H,W)
    int32, overflow (B,) int32). D attribute channels with 13 + 3D <= 32
    (D <= 6) take the planes raster (`rasterize_planes_diff`, K3 + K4 + K5,
    on the `compact` layout); wider attributes take the coverage raster
    K6 and `interpolate_attributes_fast` (K7 + K5), which bins the padded
    layout, so `compact` does not apply and overflow is 0. Coverage carries
    no gradient."""
    D = attributes.shape[-1]
    if 13 + 3 * D <= REC5_LANES:
        return rasterize_planes_diff(face_verts, attributes, image_size, capacity,
                                     compact)
    p2f, _, p2slot, bins = rasterize_coverage_pallas_v3_full(
        face_verts, image_size, capacity)
    vals, mask = interpolate_attributes_fast(
        face_verts, attributes, p2f, p2slot, bins, image_size, capacity)
    overflow = torch.zeros((face_verts.shape[0],), dtype=torch.int32,
                           device=face_verts.device)
    return vals, mask, p2f, overflow
