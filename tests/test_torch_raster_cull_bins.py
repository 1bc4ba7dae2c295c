"""K8's warp cull is exact: no pixel outside a face's K8 cull box widened by
one pixel passes K8's inside test in fp32.

K8 (csrc/raster_bins.cu) tests a face with cross-product edge terms and
division barycentrics, w_i = e_i / area, and skips it for a warp whose
16x8 pixel rectangle misses the face's box (`cull_boxes_bins`, whose
docstring derives its margin for this arithmetic) widened by one pixel.
These tests evaluate the inside test as the plain version does, at every
pixel centre of the tile grid, on random faces, slivers, near-degenerate
faces and faces on the tile edges; then a plain emulation of K8's culled
walk equals `raster_bins_coverage_plain`, which tests every face, bitwise.

K8 also skips the three divisions at a pixel where some e_i has the sign
opposite to the area's with |e_i| >= 2^-100 (and |area| <= 2^40): that
w_i is negative and cannot round to -0. The emulation applies the same
rule, and a face built so that a barycentric rounds to -0 (which passes
w_i >= 0) shows that a bare sign test would lose covered pixels and the
kernel's rule does not.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from smirk_tpu_torch.render import rasterizer as R
from test_torch_raster_cull import cull_boxes_of, faces, grid_pixels
from test_torch_raster_cull_fused import head, meets, warp_rects


SURE_E, SURE_SAFE = 2.0 ** -100, 2.0 ** 40  # the kernel's kSureE, kSureSafe


def k8_inside(v, xs, ys):
    """K8's inside test as raster_bins_coverage_plain evaluates it: v
    (..., 1, 9) face vertices, xs, ys pixel centres -> (inside, z, skip):
    skip marks the pixels the kernel rejects before dividing (some e_i of
    the sign opposite to safe's, |e_i| >= 2^-100, |safe| <= 2^40)."""
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = v.unbind(-1)
    denom = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    real = denom.abs() >= R.AREA_EPS
    safe = torch.where(real, denom, 1.0)
    e = [(x1 - xs) * (y2 - ys) - (y1 - ys) * (x2 - xs),
         (x2 - xs) * (y0 - ys) - (y2 - ys) * (x0 - xs),
         (x0 - xs) * (y1 - ys) - (y0 - ys) * (x1 - xs)]
    w0, w1, w2 = (ei / safe for ei in e)
    sgn = torch.where(denom.abs() <= SURE_SAFE, torch.where(denom > 0, 1.0, -1.0), 0.0)
    skip = torch.stack([sgn * ei for ei in e]).amin(0) <= -SURE_E
    return ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & real, w0 * z0 + w1 * z1 + w2 * z2,
            skip)


@pytest.mark.parametrize("kind", ["random", "sliver", "near_degenerate", "tile_edge"])
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), size=st.sampled_from([64, 100, 224]))
def test_every_k8_pass_lies_in_the_widened_box(kind, seed, size):
    fv = faces(kind, np.random.default_rng(seed), size)
    raw, _ = cull_boxes_of(fv, size)
    boxes = R.cull_boxes_bins(fv, size)
    xs, ys, col, row = grid_pixels(size)
    inside, _, skip = k8_inside(fv[0].reshape(-1, 1, 9), xs, ys)  # (F, pixels)
    assert not bool((inside & skip).any())
    b = boxes[0]
    inbox = ((b[:, 1:2] + 1.0 >= col) & (b[:, 0:1] - 1.0 <= col)
             & (b[:, 3:4] + 1.0 >= row) & (b[:, 2:3] - 1.0 <= row))
    assert int((inside & ~inbox).sum()) == 0
    unbounded = torch.isinf(boxes[..., 0])
    assert torch.equal(boxes[~unbounded], raw[~unbounded])
    if kind == "random":  # ordinary faces keep their boxes
        assert float(unbounded.float().mean()) <= 0.1


def culled_bins_walk(counts, bins, fv9, boxes, size):
    """K8's culled walk in plain PyTorch: each tile tries the first `count`
    faces of its bin one by one, in bin order, skipping at a pixel the
    faces whose box misses the pixel's warp rectangle and those its sign
    test rejects, and keeps a face only if inside and strictly nearer. ->
    as `raster_bins_coverage_plain`."""
    B = counts.shape[0]
    ty, tx = R._tile_grid(size)
    T = ty * tx
    xs, ys = R._tile_centers(T, size, tx, "cpu")  # (T,1024)
    c0, r0 = warp_rects(T, tx)
    best = torch.full((B, T, R.TILE_PIX), R.BIG_Z)
    win = torch.full((B, T, R.TILE_PIX), -1, dtype=torch.int32)
    bidx = torch.arange(B)[:, None, None]
    n = counts[:, :T]
    for i0 in range(0, int(n.max()), 32):
        ids = bins[:, :T, i0:i0 + 32]  # (B,T,m)
        active = (i0 + torch.arange(ids.shape[-1])) < n[..., None]
        v = fv9[bidx, ids.clamp_min(0).long()][..., None, :]  # (B,T,m,1,9)
        inside, z, skip = k8_inside(v, xs[:, None], ys[:, None])
        box = boxes[bidx, ids.clamp_min(0).long()][..., None, :]
        inside &= meets(box, c0[:, None], r0[:, None]) & active[..., None] & ~skip
        for f in range(ids.shape[-1]):
            take = inside[:, :, f] & (z[:, :, f] < best)
            best = torch.where(take, z[:, :, f], best)
            win = torch.where(take, ids[:, :, f:f + 1], win)

    def to_grid(x):
        x = x.reshape(B, ty, tx, R.TILE_ROWS, R.TILE_COLS).permute(0, 1, 3, 2, 4)
        return x.reshape(B, ty * R.TILE_ROWS, tx * R.TILE_COLS)

    return to_grid(win), to_grid(best)


def test_culled_bins_walk_matches_plain():
    """The emulated culled walk of K8 equals its plain version bitwise at
    224 px on the head's face region (capacity 384) and on slivers and
    near-degenerate faces mixed with ordinary ones (capacity 64, where
    counts are cut at the capacity); the cull skips most face-warp tests
    on the head, and leaves the thinnest slivers unbounded."""
    S = 224
    r, fv, _ = head(2, S, 3)
    rng = np.random.default_rng(5)
    mixed = torch.cat([faces(kind, rng, S) for kind in ("random", "sliver",
                                                         "near_degenerate", "tile_edge")
                       for _ in range(3)], 1)
    assert bool(torch.isinf(R.cull_boxes_bins(mixed, S)[..., 0]).any())
    for fvs, cap in ((fv, r.bin_capacity), (mixed, 64)):
        B, F = fvs.shape[:2]
        bins, counts = R.bin_faces_flat(fvs, S, cap)
        fv9 = fvs.reshape(B, F, 9).contiguous()
        boxes = R.cull_boxes_bins(fvs, S)
        got = culled_bins_walk(counts, bins, fv9, boxes, S)
        want = R.raster_bins_coverage(counts, bins, fv9, S)  # CPU: plain
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert bool((want[0] >= 0).any())
    # on the head: the face-warp tests the cull keeps, of 8 per binned face
    bins, counts = R.bin_faces_flat(fv, S, r.bin_capacity)
    c0, r0 = warp_rects(bins.shape[1], R._tile_grid(S)[1])
    c0, r0 = c0[:, :128:16][None, :, None], r0[:, :128:16][None, :, None]
    real = torch.arange(bins.shape[2]) < counts[..., None]
    bb = R.cull_boxes_bins(fv, S)[torch.arange(2)[:, None, None],
                                  bins.clamp_min(0).long()][..., None, :]
    share = float((meets(bb, c0, r0) & real[..., None]).sum()) / (int(counts.sum()) * 8)
    assert share < 0.3, share


def test_division_skip_keeps_negative_zero_barycentrics():
    """At the centre row of a 65 px image (pixel centres y = 0, and x = 0 in
    the middle) the face (0, 1), (1, 2^-149), (-1, 0) has e_0 = 2^-149 (or
    2^-148) against an area of -2: w_0 underflows to -0, which passes
    w_0 >= 0, so plain K8 covers those pixels. A bare sign test (opposite
    signs, e_i != 0) would reject them; the kernel's, |e_i| >= 2^-100,
    does not, and its emulated walk equals the plain render."""
    S = 65
    fv = torch.tensor([[[[0.0, 1.0, 10.0], [1.0, 2.0 ** -149, 10.0], [-1.0, 0.0, 10.0]]]])
    bins, counts = R.bin_faces_flat(fv, S, 32)
    fv9 = fv.reshape(1, 1, 9)
    want = R.raster_bins_coverage(counts, bins, fv9, S)  # CPU: plain
    x = R._ndc(torch.arange(S), S)
    centre = want[0][0, S // 2, :S] == 0
    v = fv9[0, :, None, :]
    x0, y0, _, x1, y1, _, x2, y2, _ = v.unbind(-1)
    e0 = (x1 - x) * (y2 - 0.0) - (y1 - 0.0) * (x2 - x)
    w0 = e0 / ((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0))
    negzero = (w0 == 0) & torch.signbit(w0) & (e0 > 0)
    assert int((centre & negzero[0]).sum()) >= 3  # covered through -0
    _, _, skip = k8_inside(v, x, torch.zeros(()))
    assert not bool(skip[0][negzero[0]].any())
    got = culled_bins_walk(counts, bins, fv9, R.cull_boxes_bins(fv, S), S)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
