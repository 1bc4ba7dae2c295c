"""K1's warp cull is exact: K1 (csrc/raster_fused.cu) culls with K3's boxes
(`cull_boxes`) and skips a face for a warp whose 16x8 pixel rectangle
misses the face's box widened by one pixel.

`cull_boxes` is exact for the edge tests of `face_records` (shown in
tests/test_torch_raster_cull.py). K1's records (`fused_records`) carry the
same edge and depth planes in lanes 0-11, bit for bit, so that proof covers
K1's edge tests. A plain-PyTorch emulation of K1's culled walk (per warp
rectangle, the faces in slot order, strictly nearer wins) then equals
`raster_fused_windows_plain`, which tests every face, bitwise; and the
port's `rasterize_normals_fused`, whose plain path the emulation equals,
holds to the JAX package's Pallas kernel in interpret mode. K1 and K3 share
their walk in a header (csrc/window_raster.cuh), so a last test holds
`kernels._stale` to it: a library is stale when a header is newer.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch import kernels
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer
from test_torch_raster import check_normals, check_p2f_zbuf
from test_torch_raster_cull import faces
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def head(B, S, seed, full=True):
    """The procedural head's face region, recentred, jittered -> (renderer,
    face_verts, face_normals) on the CPU."""
    bundle = procedural_bundle(seed=0, full_size=full)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    rng = np.random.default_rng(seed)
    verts = torch.from_numpy((vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32))
    r = Renderer(bundle, image_size=S, device="cpu")
    fv, fn = r._face_geometry(verts, r.project(verts, torch.tensor([[7.0, 0.0, 0.0]] * B)))
    return r, fv, fn


def warp_rects(Tp, tx):
    """(Tp, 1024) the left column and top row, in pixels, of the 16x8 warp
    rectangle of each pixel of each tile (row-major in the 8x128 tile)."""
    pix = torch.arange(R.TILE_PIX)
    t = torch.arange(Tp)[:, None]
    c0 = (t % tx) * R.TILE_COLS + (pix % R.TILE_COLS) // 16 * 16
    r0 = (t // tx) * R.TILE_ROWS + 0 * pix
    return c0.float(), r0.float()


def meets(box, c0, r0):
    """box (..., 4) [xmin, xmax, ymin, ymax] widened by one pixel meets the
    16x8 rectangle at (c0, r0), as the kernels' ballot tests it."""
    return ~((box[..., 1] + 1.0 < c0) | (box[..., 0] - 1.0 > c0 + 15.0)
             | (box[..., 3] + 1.0 < r0) | (box[..., 2] - 1.0 > r0 + 7.0))


def culled_fused_walk(kept, bins, records, boxes, size, tx):
    """K1's culled walk in plain PyTorch: each tile walks chunks 0 .. kept -
    1 of its bin (kept clamped to [0, C/32]); at each pixel the faces whose
    box meets the pixel's warp rectangle are tried one by one in slot order
    and kept only if inside and strictly nearer; the winner's normal planes
    at the end. -> as `raster_fused_windows_plain`."""
    B, Tp, C = bins.shape
    n = kept.clamp(0, C // R.V3_CHUNK)
    xs, ys = R._tile_centers(Tp, size, tx, "cpu")  # (Tp,1024)
    c0, r0 = warp_rects(Tp, tx)
    best = torch.full((B, Tp, R.TILE_PIX), R.BIG_Z)
    win = torch.full((B, Tp, R.TILE_PIX), -1, dtype=torch.long)
    bidx = torch.arange(B)[:, None, None]
    ext_boxes = torch.cat([boxes, torch.tensor([[[np.inf, -np.inf, np.inf, -np.inf]]])
                           .expand(B, 1, 4)], 1)  # empty slots: an empty box
    for k in range(int(n.max())):
        ids = bins[:, :, k * 32:(k + 1) * 32]  # (B,Tp,32)
        rec = R._gather_recs(records, ids.reshape(B, -1)).reshape(B, Tp, 32, 1, -1)
        box = ext_boxes[bidx, torch.where(ids < 0, boxes.shape[1], ids).long()]
        live = meets(box[..., None, :], c0[None, :, None], r0[None, :, None])  # (B,Tp,32,P)
        inside = ((R._affine(rec, 0, 1, 2, xs[:, None], ys[:, None]) >= 0)
                  & (R._affine(rec, 3, 4, 5, xs[:, None], ys[:, None]) >= 0)
                  & (R._affine(rec, 6, 7, 8, xs[:, None], ys[:, None]) >= 0)
                  & (rec[..., 12] >= 0) & live & (k < n)[..., None, None])
        z = R._affine(rec, 9, 10, 11, xs[:, None], ys[:, None])
        for f in range(32):
            take = inside[:, :, f] & (z[:, :, f] < best)
            best = torch.where(take, z[:, :, f], best)
            win = torch.where(take, k * 32 + f, win)
    covered = win >= 0
    wrec = R._gather_recs(records, torch.gather(bins, 2, win.clamp_min(0)).reshape(B, -1))
    wrec = wrec.reshape(B, Tp, R.TILE_PIX, -1)
    normals = [R._affine(wrec, 16 + d, 19 + d, 22 + d, xs, ys) for d in range(3)]
    return (torch.where(covered, wrec[..., 12].to(torch.int32), -1),
            torch.where(covered, best, R.BIG_Z),
            *[torch.where(covered, v, 0.0) for v in normals])


@pytest.mark.parametrize("scene", ["head", "slivers"])
def test_fused_records_carry_face_records_edge_lanes(scene):
    """fused_records' lanes 0-11 (edges, depth) are face_records', bitwise:
    on the head's face region, and on slivers and near-degenerate faces;
    so are the chunk-skip records' (K11's, which cull with `cull_boxes` of
    the padded faces `chunkskip_inputs` returns beside them) where the
    faces are padded."""
    if scene == "head":
        _, fv, fn = head(2, 224, 0)
    else:
        rng = np.random.default_rng(3)
        fv = torch.cat([faces(kind, rng, 224) for kind in ("sliver", "near_degenerate")
                        for _ in range(4)], 1)
        fn = torch.tensor(rng.normal(size=tuple(fv.shape)), dtype=torch.float32)
        assert bool(torch.isinf(R.cull_boxes(fv, 224)[..., 0]).any())
    assert torch.equal(R.fused_records(fv, fn)[..., :12], R.face_records(fv)[..., :12])
    fv, fn = fv[:, :-3], fn[:, :-3]  # F a multiple of no chunk size
    _, _, recs, fvp, _ = R.chunkskip_inputs(fv, fn, 224, 8, 4)
    assert fvp.shape[1] > fv.shape[1] and torch.equal(fvp[:, :fv.shape[1]], fv)
    assert torch.equal(recs[..., :12], R.face_records(fvp)[..., :12])


@pytest.mark.parametrize("compact", ["auto", None])
def test_culled_fused_walk_matches_plain(compact):
    """The emulated culled walk equals the plain version, which tests every
    face, bitwise at 224 px on the compact and padded layouts, and the cull
    skips most face-warp tests."""
    S = 224
    r, fv, fn = head(2, S, 1)
    tx = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, r.bin_capacity)
    kept, _ = R._windows(counts, r.raster_compact if compact == "auto" else None)
    records = R.fused_records(fv, fn)
    boxes = R.cull_boxes(fv, S)
    got = culled_fused_walk(kept, bins, records, boxes, S, tx)
    want = R.raster_fused_windows(kept, bins, records, fv, S, tx)  # CPU: plain
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float((want[0] >= 0).float().mean()) > 0.05
    # face-warp tests kept: a real slot whose box meets the warp's rectangle
    Tp = bins.shape[1]
    c0, r0 = warp_rects(Tp, tx)
    c0, r0 = c0[:, :128:16][None, :, None], r0[:, :128:16][None, :, None]  # (1,Tp,1,8)
    slots = (torch.arange(bins.shape[2]) < kept[..., None] * 32) & (bins >= 0)
    bb = boxes[torch.arange(2)[:, None, None], bins.clamp_min(0).long()][..., None, :]
    share = float((meets(bb, c0, r0) & slots[..., None]).sum()) / (int(kept.sum()) * 32 * 8)
    assert share < 0.3, share


def test_fused_raster_matches_jax_small():
    """rasterize_normals_fused at 64 px (the port's plain path, which the
    culled walk equals) against the JAX package's Pallas kernel in
    interpret mode, with test_torch_raster's tolerances: pix_to_face up to
    edge and depth ties, depth and normals within their rounding bound."""
    S, B = 64, 2
    r, fv, fn = head(B, S, 2, full=False)
    cap, compact = r.bin_capacity, r.raster_compact
    nt, pt, zt, ot = R.rasterize_normals_fused(fv, fn, S, capacity=cap, compact=compact,
                                               return_overflow=True)
    nj, pj, zj, oj = JR.rasterize_normals_fused(
        jnp.asarray(fv.numpy()), jnp.asarray(fn.numpy()), S, capacity=cap, interpret=True,
        compact=compact, return_overflow=True, bin_approx=0.95, bin_miss_check=True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    check_p2f_zbuf(pt, pj, zt, zj, fv, S)
    agree = pt.numpy() == np.asarray(pj)
    check_normals(nt, nj, np.where(agree, pt.numpy(), -1), fv, fn, S)
    assert (pt.numpy() >= 0).mean() > 0.05
    # the culled walk renders the same image
    tx = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, cap)
    kept, _ = R._windows(counts, compact)
    got = culled_fused_walk(kept, bins, R.fused_records(fv, fn), R.cull_boxes(fv, S), S, tx)
    assert torch.equal(R._tiles_to_image(got[0], S), pt)
    assert torch.equal(R._tiles_to_image(got[1], S), zt)


def test_stale_sees_headers(tmp_path, monkeypatch):
    """A built library is stale when its source or any header of csrc/ is
    newer than it (the sources include the shared header by name)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    name = "raster_fused"
    source = csrc / kernels.LIBRARIES[name][0]
    header = csrc / "window_raster.cuh"
    lib = build / f"lib{name}.so"
    assert kernels._stale(name)  # not built
    for p, t in ((source, 100), (header, 100), (lib, 200)):
        p.write_text("")
        os.utime(p, (t, t))
    assert not kernels._stale(name)
    os.utime(header, (300, 300))  # the shared header edited after the build
    assert kernels._stale(name)
    os.utime(header, (100, 100))
    os.utime(source, (300, 300))
    assert kernels._stale(name)
