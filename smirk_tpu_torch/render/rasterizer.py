"""Inference rasterizer: binning, face records, and the fused z-buffer.

Port of the inference subset of smirk_tpu/render/rasterizer.py. The output
contract is the JAX package's: pixel-to-face ids, z-buffer, interpolated
normals, and the `raster_overflow` count of compact chunks dropped past the
budget, with the same drop order and tie-breaks.

NDC convention: +x -> right (column), +y -> down (row), pixel (r, c) centre
at ((2c+1-W)/W, (2r+1-H)/H); smaller z is closer. Background is
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

K1 and K2 are CUDA kernels (csrc/). Each wrapper checks its arguments,
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


def raster_fused_windows_plain(starts, ends, recs, image_size: int, tiles_x: int):
    """Plain version of K1.

    starts/ends (B,Tp) int32: tile t walks chunks [starts, ends) of its
    image's record list recs (B, N*32, 32) f32. Within a chunk the nearest
    inside face wins, first slot on ties; a later chunk replaces the winner
    only if strictly nearer. -> p2f (B,Tp,1024) int32 (-1 empty), zbuf
    (1e10 empty), nx, ny, nz (0 empty), all f32 but p2f.
    """
    B, Tp = starts.shape
    dev = recs.device
    CH, L = V3_CHUNK, RECF_LANES
    chunks = recs.reshape(B, -1, CH, L)
    xs, ys = _tile_centers(Tp, image_size, tiles_x, dev)
    xs, ys = xs[None, :, None, :], ys[None, :, None, :]  # (1,Tp,1,P)
    slot = torch.arange(CH, device=dev)[None, None, :, None]
    outs = []
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
        bz, win = bz[:, :, 0], win[:, :, 0]  # (G,Tp,P)
        covered = bz < BIG_Z
        wrec = recs[bidx[:, :, None], win]  # (G,Tp,P,L)
        x, y = xs[:, :, 0], ys[:, :, 0]
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
    compact_faces.launches = 0
    raster_fused_windows.launches = 0


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
    if capacity % V3_CHUNK:
        raise ValueError(f"capacity {capacity} is not a multiple of {V3_CHUNK}")
    B = face_verts.shape[0]
    H = W = image_size
    ty = -(-H // TILE_ROWS)
    tx = -(-W // TILE_COLS)
    T = ty * tx
    CH = V3_CHUNK
    CPT = capacity // CH

    bins, counts = bin_faces_flat(face_verts, image_size, capacity)
    Tp = bins.shape[1]
    records = fused_records(face_verts, face_normals)
    if compact is not None:
        compact = -(-compact // 8) * 8
        starts, ends, tof, total, overflow = _compact_plan(counts, compact)
        faces = compact_faces(tof, starts, total,
                              bins.reshape(B, Tp * CPT, CH), CPT)
        recs = _gather_recs(records, faces.reshape(B, compact * CH))
    else:
        overflow = torch.zeros((B,), dtype=torch.int32, device=face_verts.device)
        starts, ends = padded_windows(counts, CPT)
        recs = _gather_recs(records, bins.reshape(B, Tp * capacity))
    outs = raster_fused_windows(starts, ends, recs.contiguous(), image_size, tx)

    def to_image(x):
        x = x[:, :T].reshape(B, ty, tx, TILE_ROWS, TILE_COLS)
        return x.permute(0, 1, 3, 2, 4).reshape(
            B, ty * TILE_ROWS, tx * TILE_COLS)[:, :H, :W]

    p2f = to_image(outs[0])
    zbuf = to_image(outs[1])
    normals = torch.stack([to_image(o) for o in outs[2:5]], dim=-1)
    if return_overflow:
        return normals, p2f, zbuf, overflow
    return normals, p2f, zbuf
