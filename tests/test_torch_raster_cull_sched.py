"""K9, K10 and K11 walk the shared culled window walk (csrc/window_raster.cuh):
plain-PyTorch emulations of their walks equal their plain versions bitwise.

K11 (csrc/raster_chunkskip.cu) walks each tile's chunk-id list 32 faces a
step (32 / chunk list entries; the last step of a list whose count x chunk
is no multiple of 32 is partial), culls with `cull_boxes` of the padded,
Morton-ordered faces and gives the off-screen padding faces (id -1) an
empty box. K9 (csrc/raster_groups.cu) walks each tile's own ceil(count /
32) chunks of its padded bin with `cull_boxes`, where the plain version,
the merged schedule's contract, walks every tile of a group to the group's
largest count. K10 does the same over count-sorted tiles, on records
rebased to tile-local coordinates, with the rebase's boxes
(`cull_boxes_local`) against the warp rectangles at each tile's real
position. At each pixel the emulations try the faces whose box, widened by
one pixel, meets the pixel's 16x8 warp rectangle, one by one in slot order,
keeping a face only if it is inside and strictly nearer, as the kernels do;
the plain versions test every face. Scenes: the procedural head's face
region at 224 px, and slivers and near-degenerate faces, which the cull
boxes leave unbounded, among random ones.
"""
import numpy as np
import pytest
import torch

from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as R
from test_torch_raster_cull import faces
from test_torch_raster_cull_fused import head, meets
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

S = 224
TX = -(-S // R.TILE_COLS)
EMPTY = torch.tensor([np.inf, -np.inf, np.inf, -np.inf])


def culled_walk(step_ids, n, records, boxes, order=None):
    """The kernels' culled walk in plain PyTorch. step_ids(k) -> (B,Tp,32)
    table rows of the 32 slots of step k (-1 empty); n (B,Tp) the steps of
    each tile; boxes (B,F,4) the cull boxes (an id outside [0, F) an empty
    one). order (B,Tp): K10, row t is tile order[t], its records rebased
    (`_tilelocal_adjust`) and tested at the first tile's centres. -> (p2f,
    zbuf, nx, ny, nz, kept face-warp tests, all face-warp tests)."""
    B, Tp = n.shape
    F = records.shape[1]
    local = order is not None
    pos = (order if local else torch.arange(Tp)[None].expand(B, Tp)).long()
    xs, ys = R._tile_centers(Tp, S, TX, "cpu", local=local)  # (Tp,1024)
    pix = torch.arange(R.TILE_PIX)
    c0 = ((pos % TX)[..., None] * R.TILE_COLS + (pix % R.TILE_COLS) // 16 * 16).float()
    r0 = ((pos // TX)[..., None] * R.TILE_ROWS + 0 * pix).float()  # (B,Tp,1024)
    best = torch.full((B, Tp, R.TILE_PIX), R.BIG_Z)
    win = torch.full((B, Tp, R.TILE_PIX), -1, dtype=torch.long)
    bidx = torch.arange(B)[:, None, None]
    ext_boxes = torch.cat([boxes, EMPTY.expand(B, 1, 4)], 1)

    def recs_of(ids):
        rec = R._gather_recs(records, ids.reshape(B, -1)).reshape(B, Tp, ids.shape[2], -1)
        return R._tilelocal_adjust(rec, order, S, TX) if local else rec

    steps = [step_ids(k) for k in range(int(n.max()))]
    kept = 0
    for k, ids in enumerate(steps):
        rec = recs_of(ids)[..., None, :]  # (B,Tp,32,1,32)
        box = ext_boxes[bidx, torch.where((ids < 0) | (ids >= F), F, ids).long()]
        walked = (k < n)[..., None]
        live = meets(box[..., None, :], c0[:, :, None], r0[:, :, None]) & walked[..., None]
        kept += int((live[..., :R.TILE_COLS:16] & (ids >= 0)[..., None]).sum())  # a warp's
        x, y = xs[None, :, None], ys[None, :, None]
        inside = ((R._affine(rec, 0, 1, 2, x, y) >= 0) & (R._affine(rec, 3, 4, 5, x, y) >= 0)
                  & (R._affine(rec, 6, 7, 8, x, y) >= 0) & (rec[..., 12] >= 0) & live)
        z = R._affine(rec, 9, 10, 11, x, y)
        for f in range(32):
            take = inside[:, :, f] & (z[:, :, f] < best)
            best = torch.where(take, z[:, :, f], best)
            win = torch.where(take, k * 32 + f, win)
    covered = win >= 0
    every = torch.cat(steps, 2) if steps else torch.full((B, Tp, 1), -1)
    wrec = recs_of(torch.gather(every, 2, win.clamp_min(0)))
    normals = [R._affine(wrec, 16 + d, 19 + d, 22 + d, xs, ys) for d in range(3)]
    return (torch.where(covered, wrec[..., 12].to(torch.int32), -1),
            torch.where(covered, best, R.BIG_Z),
            *[torch.where(covered, v, 0.0) for v in normals],
            kept, int(n.sum()) * 32 * 8)


def scene(name):
    """-> (face_verts (B,F,3,3), face_normals, capacity, the Morton order
    of the faces or None)."""
    if name == "head":
        r, fv, fn = head(2, S, 4)
        bundle = procedural_bundle(seed=0, full_size=True)
        tmpl = np.asarray(bundle["v_template"])[r.kept_vertices]
        return fv, fn, r.bin_capacity, R.spatial_face_order(tmpl, r.faces.numpy())
    rng = np.random.default_rng(11)
    fv = torch.cat([faces(kind, rng, S) for kind in ("random", "sliver", "near_degenerate")
                    for _ in range(12)], 1)[:, :-5]  # F a multiple of no chunk size
    fn = torch.tensor(rng.normal(size=tuple(fv.shape)), dtype=torch.float32)
    assert bool(torch.isinf(R.cull_boxes(fv, S)[..., 0]).any())
    return fv, fn, 128, None


def assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name,chunks", [("head", (8, 32)), ("slivers", (4, 16))])
def test_culled_chunk_walk_matches_plain(name, chunks):
    """K11's culled walk over each tile's chunk-id list equals its plain
    version bitwise, with the original ids of a Morton-permuted face list
    on the head; lists whose last step is partial and padding faces, which
    would never be culled by their degenerate boxes, are among them."""
    fv, fn, _, perm = scene(name)
    ids = None
    if perm is not None:
        ids = torch.as_tensor(perm)
        fv, fn = fv[:, ids], fn[:, ids]
    for chunk in chunks:
        cap = -(-fv.shape[1] // chunk)  # every chunk: nothing dropped
        counts, clist, recs, fvp, dropped = R.chunkskip_inputs(fv, fn, S, chunk, cap, ids)
        assert int(dropped.max()) == 0 and fvp.shape[1] == recs.shape[1]
        if chunk < 32:  # some list ends in a partial step
            assert bool(((counts * chunk) % 32 != 0).any())
        boxes = R.cull_boxes(fvp, S)
        pad = recs[..., 12] < 0
        assert bool(pad.any()) == (fv.shape[1] % chunk != 0)
        assert bool(torch.isinf(boxes[pad][:, 0]).all())  # the padding faces' boxes
        boxes = torch.where(pad[..., None], EMPTY, boxes)  # the kernel stages empty ones
        per = 32 // chunk
        f = torch.arange(32)

        def step_ids(k):
            e = k * per + f // chunk  # list entry of each slot
            cid = clist[..., e.clamp(max=clist.shape[2] - 1)]
            return torch.where(e < counts[..., None], cid * chunk + f % chunk, -1)

        n = (counts * chunk + 31) // 32
        *got, kept, every = culled_walk(step_ids, n, recs, boxes)
        want = R.raster_chunkskip_plain(counts, clist, recs, image_size=S, tiles_x=TX,
                                        chunk=chunk)
        assert_equal(got, want)
        assert float((want[0] >= 0).float().mean()) > 0.02
        if name == "head":
            assert kept < 0.3 * every, (chunk, kept, every)


@pytest.mark.parametrize("name", ["head", "slivers"])
def test_culled_own_count_walks_match_plain(name):
    """K9's culled walk over each tile's own chunks equals its plain
    version, which walks every tile of a group to the group's largest
    count, bitwise, and equals K1b; K10's, over count-sorted tiles on
    rebased records with `cull_boxes_local`, equals its plain version
    bitwise. The cull keeps under 30 % of the face-warp tests on the
    head."""
    fv, fn, cap, _ = scene(name)
    records = R.fused_records(fv, fn)
    bins, counts = R._pad_tiles_to(*R.bin_faces_flat(fv, S, cap), 8)
    cpt = bins.shape[2] // 32
    n = R._windows(counts, None)[0].clamp(max=cpt)
    assert bool((n < R.group_windows(counts, cpt, 8)[1] - R.group_windows(counts, cpt, 8)[0]
                 ).any())  # the group walk goes further

    def bin_steps(b):
        return lambda k: b[..., k * 32:(k + 1) * 32].long()

    *got, kept, every = culled_walk(bin_steps(bins), n, records, R.cull_boxes(fv, S))
    want = R.raster_fused_groups_plain(counts, bins, records, image_size=S, tiles_x=TX,
                                       tps=8)
    assert_equal(got, want)
    assert_equal(want, R.raster_fused_windows_plain(n, bins, records, S, TX))
    if name == "head":
        assert kept < 0.3 * every, (kept, every)
    sc, sb, order, _ = R.sort_tiles_order(bins, counts)
    local = R.cull_boxes_local(fv, S)
    *got, kept_local, _ = culled_walk(bin_steps(sb), R._windows(sc, None)[0].clamp(max=cpt),
                                      records, local, order=order)
    want = R.raster_fused_groups_local_plain(sc, sb, order, records, image_size=S,
                                             tiles_x=TX, tps=8)
    assert_equal(got, want)
    assert float((want[0] >= 0).float().mean()) > 0.02
    assert kept <= kept_local  # the wider margin culls no more
    if name == "head":
        assert kept_local < 0.3 * every, (kept_local, every)


def test_old_positional_forms_raise():
    """The signatures before the read-through walk, (counts, recs,
    image_size, tiles_x, tps), (counts, recs, image_size, tps) and (counts,
    clist, recs, image_size, tiles_x, chunk), and their plain versions',
    raise instead of being misread."""
    counts = torch.zeros((1, 8), dtype=torch.int32)
    recs = torch.zeros((1, 8 * 32, 32))
    clist = torch.zeros((1, 8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        R.raster_fused_groups(counts, recs, 64, 1, 8)
    with pytest.raises(TypeError):
        R.raster_fused_groups_plain(counts, recs, 64, 1, 8)
    with pytest.raises(TypeError):
        R.raster_fused_groups_local(counts, recs, 64, 8)
    with pytest.raises(TypeError):
        R.raster_chunkskip(counts, clist, recs, 64, 1, 8)
    with pytest.raises(TypeError):
        R.raster_chunkskip(counts, clist, recs, 64, 1, chunk=8)
    with pytest.raises(TypeError):
        R.raster_chunkskip_plain(counts, clist, recs, 64, 1, 8)
    # the new forms on the CPU: the plain versions
    fv = torch.zeros((1, 8 * 32, 3, 3))
    bins = torch.full((1, 8, 32), -1, dtype=torch.int32)
    out = R.raster_fused_groups(counts, bins, recs, fv, image_size=64, tiles_x=1, tps=8)
    assert out[0].shape == (1, 8, R.TILE_PIX) and int(out[0].max()) == -1
    out = R.raster_chunkskip(counts, clist, recs, fv, image_size=64, tiles_x=1, chunk=8)
    assert int(out[0].max()) == -1
