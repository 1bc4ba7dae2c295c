"""K10's warp cull is exact for its rebased forms: no pixel outside a face's
`cull_boxes_local` box widened by one pixel passes the face's edge tests as
K10 evaluates them.

K10 (csrc/raster_groups.cu) rebases each record to tile-local coordinates
(`_tilelocal_adjust`: c' = c + ((a * dx) + (b * dy)), one more rounding of
each constant) and evaluates the edges at the first tile's pixel centres,
while its warp rectangles stand at the tile's real position. `cull_boxes`'
32u margin was derived for the unrebased forms; `cull_boxes_local` derives
128u for these. These tests evaluate the rebased edge tests as K10's plain
version does, for every tile of the grid (padding included), and check that
every pass lies in the widened box: random faces, slivers, near-degenerate
faces and faces on the tile edges (hypothesis), and the procedural head's
face region.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from smirk_tpu_torch.render import rasterizer as R
from test_torch_raster_cull import faces, grid_pixels
from test_torch_raster_cull_fused import head


def rebased_passes_outside(face_verts, boxes, size):
    """(face, pixel) pairs of one image where K10's rebased edge tests pass
    but the pixel lies outside the box widened by one pixel -> (count,
    passes)."""
    ty, tx = R._tile_grid(size)
    T, F = ty * tx, face_verts.shape[1]
    rec = R.fused_records(face_verts, torch.zeros_like(face_verts))  # (1,F,32)
    local = R._tilelocal_adjust(rec[:, None].expand(1, T, F, 32).contiguous(),
                                torch.arange(T)[None], size, tx)[0][:, :, None]  # (T,F,1,32)
    xl, yl = R._tile_centers(1, size, tx, "cpu", local=True)  # (1,1024)
    inside = ((R._affine(local, 0, 1, 2, xl, yl) >= 0) & (R._affine(local, 3, 4, 5, xl, yl) >= 0)
              & (R._affine(local, 6, 7, 8, xl, yl) >= 0))  # (T,F,1024)
    _, _, col, row = grid_pixels(size)
    col, row = col.reshape(T, 1, -1), row.reshape(T, 1, -1)
    b = boxes[0][None]  # (1,F,4)
    inbox = ((b[..., 1:2] + 1.0 >= col) & (b[..., 0:1] - 1.0 <= col)
             & (b[..., 3:4] + 1.0 >= row) & (b[..., 2:3] - 1.0 <= row))
    return int((inside & ~inbox).sum()), int(inside.sum())


@pytest.mark.parametrize("kind", ["random", "sliver", "near_degenerate", "tile_edge"])
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), size=st.sampled_from([64, 100, 224, 300]))
def test_every_rebased_pass_lies_in_the_widened_local_box(kind, seed, size):
    fv = faces(kind, np.random.default_rng(seed), size)
    boxes = R.cull_boxes_local(fv, size)
    bad, _ = rebased_passes_outside(fv, boxes, size)
    assert bad == 0
    # the wider margin unbounds a superset of cull_boxes' faces, and keeps
    # the others' boxes (the share it keeps: the face region's test below)
    unbounded = torch.isinf(boxes[..., 0])
    assert bool((unbounded | torch.isinf(R.cull_boxes(fv, size)[..., 0]).logical_not()).all())
    assert torch.equal(boxes[~unbounded], R.cull_boxes(fv, size)[~unbounded])


def test_local_boxes_on_the_face_region():
    """The procedural head's face region at 224 px: the property holds for
    every face at every tile, under 1 % of the faces are too thin for the
    wider margin, and the bare bounding boxes miss the rebased passes of
    slivers, which the local boxes unbound."""
    _, fv, _ = head(2, 224, 3)
    boxes = R.cull_boxes_local(fv, 224)
    for b in range(2):
        bad, passes = rebased_passes_outside(fv[b:b + 1], boxes[b:b + 1], 224)
        assert bad == 0 and passes > 0
    assert float(torch.isinf(boxes[..., 0]).float().mean()) < 0.01
    rng = np.random.default_rng(0)
    bad_raw = bad = 0
    for _ in range(10):
        fv = faces("sliver", rng, 224)
        raw = torch.stack(R._bbox_and_priority(fv, 224)[:4], -1)
        bad_raw += rebased_passes_outside(fv, raw, 224)[0]
        bad += rebased_passes_outside(fv, R.cull_boxes_local(fv, 224), 224)[0]
    assert bad_raw > 0 and bad == 0
