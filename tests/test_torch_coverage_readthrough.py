"""K6 reads its records through the bins and culls per warp; K7 reads only
the rows its contract needs, in blocks sized for residency.

K6 (csrc/raster_coverage.cu) takes each tile's kept chunk count, the bins
and the (B,F,16) coverage records (`coverage_records`), and runs K1's and
K3's walk (csrc/window_raster.cuh, at 16 floats a record): the records are
read through the bins, and a warp skips a face whose cull box
(`cull_boxes`) widened by one pixel misses its 16x8 rectangle. Its plain
version over these inputs equals, bitwise, the route it replaces (a padded
chunk-window list of gathered records walked by `_plain_zbuffer`), and a
plain-PyTorch emulation of the culled walk equals the plain version, which
tests every face. A call in the old (starts, ends, recs) form raises.

K7 (csrc/segment_reduce.cu) loads a pixel's payload row only when its slot
is in [0, C) (in its block's run of slots): rows of other slots never enter
the sums, even when they hold NaN. Its blocks' shape comes from
`_reduce_blocks`, a pure function.
"""
import numpy as np
import pytest
import torch

from smirk_tpu_torch.render import rasterizer as R
from test_torch_raster_cull import faces
from test_torch_raster_cull_fused import head, meets, warp_rects
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

# an H100's opt-in shared memory per block and per SM (bytes); a block
# also holds 1 KB the system reserves
OPTIN, SM_SHARED, RESERVED = 232448, 233472, 1024


def packed_route(counts, bins, records, size, tx):
    """The route K6 replaces: the padded chunk windows of a per-bin-slot
    gathered record list (empty slots a kill row), walked by
    `_plain_zbuffer` -> p2f, zbuf, slot (B,Tp,1024)."""
    B, Tp, C = bins.shape
    starts, ends = R.padded_windows(counts, C // R.V3_CHUNK)
    recs = R._gather_recs(records, bins.reshape(B, -1)).contiguous()
    outs = [R._winner_and_slot(starts, recs, *group[:3])[2:]
            for group in R._plain_zbuffer(starts, ends, recs, size, tx)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def culled_coverage_walk(kept, bins, records, boxes, size, tx):
    """K6's culled walk in plain PyTorch on (B,F,16) records: each tile
    walks chunks 0 .. kept - 1 of its bin (kept clamped to [0, C/32]); at
    each pixel the faces whose box meets the pixel's warp rectangle are
    tried one by one in slot order and kept only if inside and strictly
    nearer; the winner's id from the bin row. -> (as
    `raster_coverage_windows_plain`, face-warp tests kept, all)."""
    B, Tp, C = bins.shape
    n = kept.clamp(0, C // R.V3_CHUNK)
    xs, ys = R._tile_centers(Tp, size, tx, "cpu")
    c0, r0 = warp_rects(Tp, tx)
    best = torch.full((B, Tp, R.TILE_PIX), R.BIG_Z)
    win = torch.full((B, Tp, R.TILE_PIX), -1, dtype=torch.long)
    bidx = torch.arange(B)[:, None, None]
    ext_boxes = torch.cat([boxes, torch.tensor([[[np.inf, -np.inf, np.inf, -np.inf]]])
                           .expand(B, 1, 4)], 1)  # empty slots: an empty box
    kept_tests = 0
    for k in range(int(n.max())):
        ids = bins[:, :, k * 32:(k + 1) * 32]  # (B,Tp,32)
        rec = R._gather_recs(records, ids.reshape(B, -1)).reshape(B, Tp, 32, 1, -1)
        box = ext_boxes[bidx, torch.where(ids < 0, boxes.shape[1], ids).long()]
        live = meets(box[..., None, :], c0[None, :, None], r0[None, :, None])  # (B,Tp,32,P)
        walked = (k < n)[..., None, None]
        kept_tests += int((live & walked)[..., :R.TILE_COLS:16].sum())  # one pixel a warp
        inside = ((R._affine(rec, 0, 1, 2, xs[:, None], ys[:, None]) >= 0)
                  & (R._affine(rec, 3, 4, 5, xs[:, None], ys[:, None]) >= 0)
                  & (R._affine(rec, 6, 7, 8, xs[:, None], ys[:, None]) >= 0)
                  & (rec[..., 12] >= 0) & live & walked)
        z = R._affine(rec, 9, 10, 11, xs[:, None], ys[:, None])
        for f in range(32):
            take = inside[:, :, f] & (z[:, :, f] < best)
            best = torch.where(take, z[:, :, f], best)
            win = torch.where(take, k * 32 + f, win)
    covered = win >= 0
    p2f = torch.where(covered, torch.gather(bins, 2, win.clamp_min(0)), -1)
    return ((p2f.to(torch.int32), torch.where(covered, best, R.BIG_Z),
             torch.where(covered, win, -1).to(torch.int32)),
            kept_tests, int(n.sum()) * 32 * 8)


@pytest.mark.parametrize("cap", [96, 512])
def test_coverage_plain_matches_packed_route(cap):
    """K6's plain version over (kept, bins, records) equals, bitwise, the
    packed route it replaces at 224 px, at capacity 96 (bins truncated)
    and 512; `_v3_impl` renders the same image."""
    S = 224
    _, fv, _ = head(2, S, 3)
    tx = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, cap)
    records = R.coverage_records(fv)
    kept = R._windows(counts, None)[0]
    got = R.raster_coverage_windows_plain(kept, bins, records, S, tx)
    want = packed_route(counts, bins, records, S, tx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float((got[0] >= 0).float().mean()) > 0.05
    assert int(got[2].max()) < cap and int(got[2].max()) >= 32  # walks past chunk 0
    p2f, zbuf, p2slot, bins3 = R._v3_impl(fv, S, cap)
    assert torch.equal(bins3, bins)
    for a, b in zip((p2f, zbuf, p2slot), got):
        assert torch.equal(a, R._tiles_to_image(b, S))


@pytest.mark.parametrize("scene", ["head", "slivers"])
def test_culled_coverage_walk_matches_plain(scene):
    """The emulated culled walk over 16-float records equals the plain
    version, which tests every face, bitwise: on the head's face region
    (the cull keeps under 30 % of the face-warp tests) and on slivers and
    near-degenerate faces, which `cull_boxes` leaves unbounded."""
    S = 224
    if scene == "head":
        _, fv, _ = head(2, S, 1)
    else:
        rng = np.random.default_rng(5)
        fv = torch.cat([faces(kind, rng, S) for kind in ("sliver", "near_degenerate",
                                                          "random", "tile_edge")
                        for _ in range(6)], 1)
        assert bool(torch.isinf(R.cull_boxes(fv, S)[..., 0]).any())
    tx = -(-S // R.TILE_COLS)
    bins, counts = R.bin_faces_flat(fv, S, 512)
    kept = R._windows(counts, None)[0]
    records = R.coverage_records(fv)
    got, kept_tests, all_tests = culled_coverage_walk(kept, bins, records,
                                                      R.cull_boxes(fv, S), S, tx)
    want = R.raster_coverage_windows(kept, bins, records, fv, S, tx)  # CPU: plain
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    share = kept_tests / all_tests
    print(f"{scene}: the cull keeps {kept_tests} of {all_tests} face-warp tests "
          f"({share * 100:.1f} %)")
    assert float((want[0] >= 0).float().mean()) > (0.05 if scene == "head" else 0.0)
    if scene == "head":
        assert share < 0.3, share


def test_old_window_form_raises():
    """A call in the old (starts, ends, recs, image_size, tiles_x) form
    raises: the plain versions of K6 and K1 refuse a 2-D bins (ValueError)
    rather than misread it, and K6's wrapper, which now also takes the face
    vertices, is missing an argument."""
    S = 64
    _, fv, fn = head(1, S, 0, full=False)
    bins, counts = R.bin_faces_flat(fv, S, 64)
    starts, ends = R.padded_windows(counts, 2)
    recs = R._gather_recs(R.coverage_records(fv), bins.reshape(1, -1)).contiguous()
    with pytest.raises(ValueError):
        R.raster_coverage_windows_plain(starts, ends, recs, S, 1)
    with pytest.raises((TypeError, ValueError)):
        R.raster_coverage_windows(starts, ends, recs, S, 1)
    frecs = R._gather_recs(R.fused_records(fv, fn), bins.reshape(1, -1)).contiguous()
    with pytest.raises(ValueError):
        R.raster_fused_windows_plain(starts, ends, frecs, S, 1)
    kept = R._windows(counts, None)[0]
    assert R.raster_coverage_windows(kept, bins, R.coverage_records(fv), fv, S, 1)[0].shape \
        == (1, bins.shape[1], R.TILE_PIX)


@pytest.mark.parametrize("cap,chn", [(512, 36), (1024, 72), (96, 7)])
def test_reduce_blocks_sized_for_residency(cap, chn):
    """K7's blocks: a run of slots x a group of channels whose accumulators
    stay within the per-block budget, so that with the pixel list at least
    6 blocks fit an H100 SM; every width a multiple of 4 channels where
    CHN is one (all of them here: a row takes at most 32 lanes); every run
    a multiple of 8 slots (whole 128-byte lines of output) unless one run
    holds the capacity; runs and groups cover C and CHN once. One block of
    all C x CHN would hold 74 KB at C=512, CHN=36 (3 blocks an SM)."""
    width, span = R._reduce_blocks(cap, chn, OPTIN)
    assert 1 <= width <= chn and 1 <= span <= cap
    assert span * width * 4 <= R.K7_BLOCK_BYTES
    block = span * width * 4 + R.K7_LIST_BYTES + RESERVED
    assert SM_SHARED // block >= 6
    if chn % 4 == 0:
        assert width % 4 == 0
    assert span % 8 == 0 or span == cap
    runs, groups = -(-cap // span), -(-chn // width)
    assert (runs - 1) * span < cap <= runs * span
    assert (groups - 1) * width < chn <= groups * width
    assert {(512, 36): (36, 176), (1024, 72): (72, 104), (96, 7): (7, 96)}[(cap, chn)] \
        == (width, span)


def test_dropped_rows_never_enter_the_sums():
    """segment_sum (K7's plain version) with NaN in every row whose slot is
    -1 or >= C equals the sum with those rows zeroed: K7 may leave those
    rows unread. Padding pixels (slot 0, zero rows) add nothing."""
    cap, chn = 64, 12
    rng = np.random.default_rng(11)
    slots = torch.from_numpy(rng.integers(-1, cap + cap // 4, (2, 8, R.TILE_PIX))
                             .astype(np.int32))
    slots[:, -1, -100:] = 0  # padding pixels
    payload = torch.from_numpy(rng.normal(size=(2, 8, R.TILE_PIX, chn)).astype(np.float32))
    payload[:, -1, -100:] = 0.0
    dropped = (slots < 0) | (slots >= cap)
    assert bool(dropped.any()) and bool((slots >= cap).any())
    zeroed = torch.where(dropped[..., None], 0.0, payload)
    nan = torch.where(dropped[..., None], float("nan"), payload)
    want = R.segment_sum(slots, zeroed, cap)
    got = R.segment_reduce_tiles(slots, nan, cap)  # CPU: segment_sum
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)
    assert float(want.abs().sum()) > 0
