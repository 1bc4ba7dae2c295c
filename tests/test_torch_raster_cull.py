"""K3's warp cull is exact: no pixel outside a face's cull box widened by
one pixel passes the face's edge tests in fp32.

K3 (csrc/raster_planes.cu) skips a face for a warp whose 16x8 pixel
rectangle misses the face's box (`cull_boxes`) widened by one pixel on
every side. That changes no output if every pixel where the plain version's
edge tests pass lies inside the widened box: then no skipped face could
have won a pixel of the warp. These tests evaluate the edge tests as the
plain walk does (the records of `face_records`, `_affine` at the pixel
centres of the whole tile grid, padding included) and check it, on random
faces, slivers, near-degenerate faces and faces on the tile edges, and on
the procedural head's face region. The bare bounding boxes do not have the
property for slivers (shown below), which is why `cull_boxes` unbounds the
faces too thin for it.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer

F = 32  # faces per example


def grid_pixels(size):
    """The tile grid's pixels: NDC centres and pixel coordinates, (1, T*1024)."""
    ty, tx = R._tile_grid(size)
    T = ty * tx
    xs, ys = R._tile_centers(T, size, tx, "cpu")
    pix = torch.arange(R.TILE_PIX)
    t = torch.arange(T)
    col = pix[None] % R.TILE_COLS + (t % tx)[:, None] * R.TILE_COLS
    row = pix[None] // R.TILE_COLS + (t // tx)[:, None] * R.TILE_ROWS
    return (xs.reshape(1, -1), ys.reshape(1, -1), col.reshape(1, -1).float(),
            row.reshape(1, -1).float())


def passes_outside(face_verts, boxes, size):
    """(face, pixel) pairs of one image where the plain edge tests pass but
    the pixel lies outside the box widened by one pixel -> (count, passes)."""
    xs, ys, col, row = grid_pixels(size)
    rec = R.face_records(face_verts)[0][:, None, :]  # (F,1,16)
    inside = ((R._affine(rec, 0, 1, 2, xs, ys) >= 0) & (R._affine(rec, 3, 4, 5, xs, ys) >= 0)
              & (R._affine(rec, 6, 7, 8, xs, ys) >= 0))
    b = boxes[0]
    inbox = ((b[:, 1:2] + 1.0 >= col) & (b[:, 0:1] - 1.0 <= col)
             & (b[:, 3:4] + 1.0 >= row) & (b[:, 2:3] - 1.0 <= row))
    return int((inside & ~inbox).sum()), int(inside.sum())


def to_ndc(px, size):
    """Pixel coordinates -> NDC, the inverse of px = (x*W + W - 1) / 2."""
    return (2.0 * px - size + 1.0) / size


def faces(kind, rng, size):
    """F faces (1,F,3,3) f32 of one kind, vertices in pixel coordinates
    first: 'random' (0.3 to 50 px, anywhere on or near the image), 'sliver'
    (the third vertex 1e-7 to 0.1 NDC off the line of the other two, inside
    or past their segment; half of them with that line along a row of pixel
    centres), 'near_degenerate' (the same, 1e-12 to 1e-6 NDC off)
    and 'tile_edge' (vertices on the half-pixel lattice around tile
    boundaries, jittered by at most 1e-4 px, so edges run through pixel
    centres)."""
    p0 = rng.uniform(-10, size + 10, (F, 2))
    d = rng.normal(size=(F, 2)) * 10 ** rng.uniform(-0.5, 1.7, (F, 1))
    if kind == "random":
        p1, p2 = p0 + d, p0 + rng.normal(size=(F, 2)) * 10 ** rng.uniform(-0.5, 1.7, (F, 1))
    elif kind in ("sliver", "near_degenerate"):
        row = rng.random(F) < 0.5  # half of them along a pixel row
        p0[row, 1] = np.round(p0[row, 1])
        d[row, 1] = 0.0
        p1 = p0 + d
        perp = np.stack([-d[:, 1], d[:, 0]], -1) / np.linalg.norm(d, axis=-1, keepdims=True)
        lo, hi = (-7, -1) if kind == "sliver" else (-12, -6)
        off = 10 ** rng.uniform(lo, hi, (F, 1)) * size / 2  # pixels
        p2 = p0 + rng.uniform(-0.5, 1.5, (F, 1)) * d + off * perp
    else:
        ty, tx = R._tile_grid(size)
        edge = np.stack([rng.integers(0, tx + 1, F) * R.TILE_COLS - 0.5,
                         rng.integers(0, ty + 1, F) * R.TILE_ROWS - 0.5], -1)
        pts = edge[:, None] + np.round(rng.uniform(-6, 6, (F, 3, 2)) * 2) / 2
        pts += rng.uniform(-1e-4, 1e-4, pts.shape) * (rng.random((F, 3, 1)) < 0.5)
        p0, p1, p2 = pts[:, 0], pts[:, 1], pts[:, 2]
    xy = to_ndc(np.stack([p0, p1, p2], 1), size)
    z = rng.uniform(9.0, 11.0, (F, 3, 1))
    return torch.tensor(np.concatenate([xy, z], -1)[None], dtype=torch.float32)


def cull_boxes_of(fv, size):
    """-> (the bare bounding boxes (1,F,4), as the binning computes them, the
    cull boxes (1,F,4))."""
    return torch.stack(R._bbox_and_priority(fv, size)[:4], -1), R.cull_boxes(fv, size)


@pytest.mark.parametrize("kind", ["random", "sliver", "near_degenerate", "tile_edge"])
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), size=st.sampled_from([64, 100, 224]))
def test_every_pass_lies_in_the_widened_cull_box(kind, seed, size):
    fv = faces(kind, np.random.default_rng(seed), size)
    raw, boxes = cull_boxes_of(fv, size)
    bad, _ = passes_outside(fv, boxes, size)
    assert bad == 0
    unbounded = torch.isinf(boxes[..., 0])
    assert torch.equal(boxes[~unbounded], raw[~unbounded])
    if kind == "random":  # ordinary faces keep their boxes
        assert float(unbounded.float().mean()) <= 0.1


def test_bare_boxes_miss_sliver_passes():
    """Slivers pass their fp32 edge tests up to a pixel or more past their
    bounding box (the error of c = x_j y_k - y_j x_k against a vanishing
    area); the cull boxes unbound them, and keep the others."""
    rng = np.random.default_rng(0)
    bad_raw = bad = 0
    for _ in range(20):
        fv = faces("sliver", rng, 224)
        raw, boxes = cull_boxes_of(fv, 224)
        bad_raw += passes_outside(fv, raw, 224)[0]
        bad += passes_outside(fv, boxes, 224)[0]
    assert bad_raw > 0 and bad == 0


def test_cull_on_the_face_region():
    """The procedural head's face region at 224 px: the property holds for
    every face, few faces are too thin to cull, and a binned face meets
    the widened rectangles of fewer than 2 of a tile's 8 warps."""
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    rng = np.random.default_rng(0)
    B, S = 2, 224
    verts = torch.from_numpy((vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape)).astype(np.float32))
    r = Renderer(bundle, image_size=S, device="cpu")
    fv, _ = r._face_geometry(verts, r.project(verts, torch.tensor([[7.0, 0.0, 0.0]] * B)))
    bins, _ = R.bin_faces_flat(fv, S, r.bin_capacity)
    boxes = R.cull_boxes(fv, S)
    for b in range(B):
        bad, passes = passes_outside(fv[b:b + 1], boxes[b:b + 1], S)
        assert bad == 0 and passes > 0
    assert float(torch.isinf(boxes[..., 0]).float().mean()) < 0.02
    Tp = bins.shape[1]
    ty, tx = R._tile_grid(S)
    t, w = torch.arange(Tp)[:, None], torch.arange(8)[None]
    wc0 = ((t % tx) * R.TILE_COLS + w * 16).float()[None, :, None]  # (1,Tp,1,8)
    wr0 = ((t // tx) * R.TILE_ROWS).float().expand(Tp, 8)[None, :, None]
    bb = boxes[torch.arange(B)[:, None, None], bins.clamp_min(0).long()]  # (B,Tp,C,4)
    meet = ~((bb[..., 1:2] + 1 < wc0) | (bb[..., 0:1] - 1 > wc0 + 15)
             | (bb[..., 3:4] + 1 < wr0) | (bb[..., 2:3] - 1 > wr0 + 7))
    real = bins >= 0
    warps = meet.sum(-1)[real].float()
    assert bool((warps >= 1).all()) and float(warps.mean()) < 2.0
