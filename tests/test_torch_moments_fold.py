"""K4's fold epilogue and K5's ballot walk, on the CPU.

`segment_moments_to_faces` (K4 with its fold epilogue, the training
backward's one launch) against the JAX package's `segment_reduce_moments`
followed by its `fold_slots_to_faces` (Pallas, interpret mode); float64
emulations of what the two CUDA kernels read and add, which must equal the
plain versions and count the rows they touch; the wrapper's argument check;
the backward's route; the shared-memory split with the fold's marks.

Tolerance: K4 and K5 reorder fp32 sums (one-hot matmuls in JAX, scatters
and atomics here): every element within 1e-5 x the sum of the magnitudes
of its terms (the same operation on the absolute values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu.render import rasterizer as JR
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.render import rasterizer as TR
from smirk_tpu_torch.render.renderer import Renderer
from test_torch_raster import make_scene
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

SUM_RTOL = 1e-5


def assert_within(got, want, scale):
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    ratio = (got.double() - want.double()).abs() / (SUM_RTOL * scale.double() + 1e-30)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


def head_faces(B, size=224):
    """The procedural head at FLAME's counts, its face region recentred as
    chip_smoke.py's cam_fix does, jittered per image, at cam [7, 0, 0] ->
    (renderer, face_verts, face_normals) on the CPU."""
    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
    bundle["v_template"] = vt
    rng = np.random.default_rng(0)
    verts = torch.from_numpy((vt[None] + rng.normal(0, 3e-4, (B,) + vt.shape))
                             .astype(np.float32))
    r = Renderer(bundle, image_size=size, device="cpu")
    cam = torch.tensor([[7.0, 0.0, 0.0]] * B)
    return (r, *r._face_geometry(verts, r.project(verts, cam)))


def fold_scale(slots, g_t, bins, cap, size, F):
    """The fold's terms' magnitudes: |g x|, |g y|, |g| summed per face."""
    return TR.fold_slots_to_faces_plain(
        TR.segment_sum(slots, TR.moment_rows(g_t, size).abs(), cap), bins, F)


def test_fold_entry_matches_jax():
    """segment_moments_to_faces on the CPU equals JAX's
    fold_slots_to_faces(segment_reduce_moments(...)) in interpret mode."""
    r, _, _, fv, fn = make_scene(procedural_bundle(seed=1, full_size=False), 64, 2, 0)
    cap, F = r.bin_capacity, fv.shape[1]
    _, _, _, slots, bins, _ = TR._v5_impl(fv, fn, 64, cap, r.raster_compact)
    g = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    g_t = TR.image_to_tiles(torch.from_numpy(g), 64)
    ours = TR.segment_moments_to_faces(slots, g_t, bins, cap, 64, F)
    ref = JR.fold_slots_to_faces(
        JR.segment_reduce_moments(jnp.asarray(slots.numpy()), jnp.asarray(g_t.numpy()),
                                  cap, 64, True), jnp.asarray(bins.numpy()), F, True)
    assert ours.shape == (2, F, 9)
    assert_within(ours, ref, fold_scale(slots, g_t, bins, cap, 64, F))
    assert float(ours.abs().sum()) > 0


def test_fold_epilogue_emulation_counts_the_won_slots():
    """K4's walk and fold epilogue in float64 on the head at b2, 224 px,
    C = 384: a warp's pixels on one slot summed first (one set of atomics a
    (warp row, slot)), a slot marked where a pixel reached it, and only the
    marked slots whose bin id lies in [0, F) added into the face table. It
    equals the plain composition; the rows it folds are the won slots
    (~19 % of the slots; ~21 % hold a face)."""
    r, fv, fn = head_faces(2)
    S, cap, F = 224, r.bin_capacity, fv.shape[1]
    _, _, _, slots, bins, _ = TR._v5_impl(fv, fn, S, cap, r.raster_compact)
    g = np.random.default_rng(1).normal(size=(2, S, S, 3)).astype(np.float32)
    g_t = TR.image_to_tiles(torch.from_numpy(g), S)
    B, Tp, P = slots.shape
    rows = TR.moment_rows(g_t, S).double()  # the kernel's fp32 products
    live = (slots >= 0) & (slots < cap)
    b, t, p = torch.nonzero(live, as_tuple=True)
    s = slots[live].long()
    # the peer groups: (image, tile, warp row segment of 32 pixels, slot)
    groups = torch.unique(torch.stack([b, t, p // 32, s]), dim=1).shape[1]
    acc = torch.zeros((B, Tp, cap, rows.shape[-1]), dtype=torch.float64)
    acc.index_put_((b, t, s), rows[b, t, p], accumulate=True)
    marked = torch.zeros((B, Tp, cap), dtype=torch.bool)
    marked[b, t, s] = True
    keep = marked & (bins >= 0) & (bins < F)
    out = torch.zeros((B * F, rows.shape[-1]), dtype=torch.float64)
    kb = torch.arange(B)[:, None, None].expand_as(keep)[keep]
    out.index_add_(0, kb * F + bins[keep].long(), acc[keep])
    folded, won, hold = int(keep.sum()), int(marked.sum()), int((bins >= 0).sum())
    print(f"rows folded {folded} = won slots {won} of {bins.numel()} "
          f"({folded / bins.numel() * 100:.1f} %; {hold / bins.numel() * 100:.1f} % hold "
          f"a face); live pixels {int(live.sum())} ({live.float().mean() * 100:.1f} %) "
          f"in {groups} peer groups")
    assert folded == won and 0.10 < folded / bins.numel() < 0.30 and won < hold
    assert groups < int(live.sum())
    want = TR.segment_moments_to_faces_plain(slots, g_t, bins, cap, S, F)
    assert_within(out.reshape(B, F, -1), want, fold_scale(slots, g_t, bins, cap, S, F))


def test_k5_ballot_walk_reads_only_the_rows_of_faces():
    """K5's walk on the op path's shapes (the head at b2, 224 px, C = 512,
    36 channels): runs of 32 slot rows, a ballot of the bin ids in [0, F),
    only those rows read in float4 pieces and the nonzero pieces added.
    With NaN in every row of a slot that holds no face it reads ~16 % of
    the rows, never a NaN, and equals fold_slots_to_faces_plain, which the
    wrapper runs on the CPU (finite too)."""
    r, fv, _ = head_faces(2)
    F = fv.shape[1]
    bins, _ = TR.bin_faces_flat(fv, 224, 512)
    B, Tp, C = bins.shape
    rng = np.random.default_rng(2)
    per_slot = torch.from_numpy(rng.normal(size=(B, Tp, C, 36)).astype(np.float32))
    per_slot[torch.from_numpy(rng.random((B, Tp, C)) < 0.3)] = 0.0  # all-zero rows
    held = (bins >= 0) & (bins < F)
    per_slot[~held] = float("nan")
    ids = bins.reshape(B, -1, 32)  # the warps' runs
    ballot = (ids >= 0) & (ids < F)
    read = per_slot.reshape(B, -1, 32, 36)[ballot]  # the listed rows alone
    pieces = read.reshape(-1, 9, 4).double()
    nonzero = (pieces != 0).any(-1)  # a piece of zeros adds nothing
    to = (torch.arange(B)[:, None, None].expand_as(ballot)[ballot] * F
          + ids[ballot].long())
    out = torch.zeros((B * F, 9, 4), dtype=torch.float64)
    out.index_add_(0, to, torch.where(nonzero[..., None], pieces, 0.0))
    print(f"rows read {read.shape[0]} of {bins.numel()} "
          f"({read.shape[0] / bins.numel() * 100:.1f} %); runs with none "
          f"{int((~ballot.any(-1)).sum())} of {ballot.shape[0] * ballot.shape[1]}")
    assert bool(torch.isfinite(read).all()) and read.shape[0] == int(held.sum())
    assert 0.08 < read.shape[0] / bins.numel() < 0.25
    want = TR.fold_slots_to_faces_plain(per_slot, bins, F)
    scale = TR.fold_slots_to_faces_plain(per_slot.abs(), bins, F)
    assert bool(torch.isfinite(want).all())
    assert_within(out.reshape(B, F, 36), want, scale)
    assert torch.equal(TR.fold_slots_to_faces(per_slot, bins, F), want)


def test_fold_wrapper_rejects_mismatched_bins():
    """A bins whose shape is not (B, Tp, capacity) raises ValueError on the
    CPU too, before any dispatch."""
    slots = torch.full((2, 8, 1024), -1, dtype=torch.int32)
    g = torch.zeros((2, 8, 1024, 3))
    bins = torch.full((2, 8, 64), -1, dtype=torch.int32)
    assert TR.segment_moments_to_faces(slots, g, bins, 64, 64, 10).shape == (2, 10, 9)
    for bad in (bins[:, :, :32], bins[:1], bins[:, :4]):
        with pytest.raises(ValueError):
            TR.segment_moments_to_faces(slots, g, bad, 64, 64, 10)


def test_planes_backward_calls_the_fold_entry_alone(monkeypatch):
    """The training raster's backward (D <= 6) calls segment_moments_to_faces
    once and neither segment_moments nor fold_slots_to_faces; the op path's
    backward (D > 6) still folds K7's rows with fold_slots_to_faces."""
    calls = []

    def spy(name):
        fn = getattr(TR, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(TR, name, wrapped)

    for name in ("segment_moments", "segment_moments_to_faces", "fold_slots_to_faces",
                 "segment_reduce_tiles"):
        spy(name)
    r, _, _, fv, fn = make_scene(procedural_bundle(seed=1, full_size=False), 64, 1, 0)
    for D, want in ((3, ["segment_moments_to_faces"]),
                    (9, ["segment_reduce_tiles", "fold_slots_to_faces"])):
        calls.clear()
        attrs = torch.cat([fn] * (D // 3), -1).requires_grad_(True)
        vals, _, _, _ = TR.rasterize(fv, attrs, 64, r.bin_capacity)
        vals.sum().backward()
        assert calls == want, (D, calls)
        assert float(attrs.grad.abs().sum()) > 0


class _Limit:
    """A library stand-in whose opt-in shared memory is an H100's."""

    @staticmethod
    def smirk_max_shared_optin(device):
        return 232448


def test_fold_shared_memory_split():
    """K4 keeps the tile's pixel centres beside its accumulators, and the
    fold also its marks (a byte a slot) and warp lists: at C = 384, D = 3
    one block holds all 9 channels (16 KB); at C = 4096, D = 6 (295 KB of
    accumulators) both epilogues split the 18 channels into 2 groups of
    9."""
    dev = torch.device("cpu", 0)
    limit = _Limit.smirk_max_shared_optin(0)
    for cap, D in ((384, 3), (4096, 6)):
        for reserve in (TR.K4_CENTRE_BYTES, TR._fold_reserve(cap)):
            group = TR._channel_group(_Limit, cap, 3 * D, dev, reserve)
            assert group == 9 and cap * group * 4 + reserve <= limit
