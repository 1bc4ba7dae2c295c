#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (smirk_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # infer b64, train + op path b32, 224 px, fp32
    python3 chip_smoke.py --quick    # build + kernel checks at batch 8 only

Phases (any failure exits non-zero):
 1. the device: name, count, and `nvidia-smi` name + power limit;
 2. build the CUDA kernels from csrc/ with nvcc (one process per source,
    all at once) and print ptxas's registers / shared memory / spills;
 3. K2's contract through the read-through path: K1 (b64) and K3 (b32)
    take each tile's kept chunk count, the bins and the record table
    (`_windows`), and at the default budget and at a budget of 8 chunks
    their renders equal, bitwise, the plain renders over the packed route
    the TPU takes (`_compact_plan` + `compact_faces_plain` + a record
    gather, `packed_layout_plain`), with equal overflow;
 4. K1 raster_fused_windows (bins read through, the warp bounding-box
    cull) on the compact and padded (K1b) layouts vs its plain version,
    which tests every face: pix_to_face, zbuf and normals bitwise equal;
    compact == padded when nothing overflows; a truncated budget (24
    chunks) overflows and renders its trailing tiles empty;
 4b. K3 raster_planes_windows (the differentiable raster's forward, with
    the warp bounding-box cull) on the compact and padded (K3b) layouts vs
    its plain version, which tests every face, at the training shapes
    (b32): pix_to_face, zbuf, slot and the 3 value planes bitwise equal; a
    truncated budget (24 chunks) gives the plan's overflow and renders the
    clipped tiles empty with slot -1;
 4c. K4 at the training shapes (b32, C=384, D=3, F=3408): its fold
    epilogue (segment_moments_to_faces, what the training backward runs)
    against the plain composition fold_slots_to_faces_plain(
    segment_moments_plain(...)), its store epilogue (segment_moments)
    against segment_moments_plain, and K5 fold_slots_to_faces on the
    store's 9-channel rows against its plain version: every element within
    1e-5 x the sum of the magnitudes of its terms;
 4d. the raster gradient (K3 -> K4's fold -> attr_planes) at b4 against a
    dense gather-based autograd reference on the card and against the
    port's CPU path, within 1e-4 x its rounding scale
    (rasterizer.dense_gradient_and_scale); the forward and backward
    launched K3 and K4's fold once each, and neither K4's store nor K5;
 4e. K6 raster_coverage_windows (16-float records read through the
    padded bins, the warp cull of K1 and K3) at b32, 224 px on the face
    region at capacity 512 and 384: pix_to_face, zbuf and slot bitwise
    equal to its plain version, which tests every face, and to K3's on the
    same (kept, bins, face_verts);
 4f. K7 segment_reduce_tiles against `segment_sum` (one scatter_add_),
    every element within 1e-5 x the sum of the magnitudes of its terms,
    with NaN in every payload row whose slot is outside [0, C) (the
    contract drops them; K7 never reads them) and the output finite: 36
    channels at capacity 512 on K6's slots (3 runs of 176 slots, 25 KB of
    accumulators a block), and 72 channels at capacity 1024 (10 runs of
    104); the share of pixels whose rows are read; then K5 at the op
    path's shapes on K7's output (C=512, 36 channels, F=3408) with NaN in
    every row of a slot that holds no face: finite and within 1e-5 x the
    sum of magnitudes of its plain version; the share of rows it reads;
 4g. K8 raster_bins_coverage (staged one chunk ahead, the warp cull with
    its own boxes, `cull_boxes_bins`) at b32, capacity 384: bitwise equal
    to its plain version, which tests every face, and against K6's
    pix_to_face by the tests' edge/depth tie rule;
 4h. K4 at D = 6, capacity 768 (55 KB of accumulators), both epilogues
    (the fold on random face ids) against their plain versions, within
    1e-5 x the sum of magnitudes;
 4i. the scheduled inference rasters on the main path's faces (b64, the
    face region through Renderer._face_geometry), capacity 384, all three
    on K1's culled walk over records read through their ids: K9
    raster_fused_groups at tps 8 and 16 bitwise equal to its plain version
    (the merged schedule's group walk) and to K1b; K10
    raster_fused_groups_local (count-sorted tiles, records rebased to
    tile-local coordinates in its staging) bitwise equal to its plain
    version and to K1b by the tie rule, normals within 2e-4 + 1e-3 x |n|;
    K11 raster_chunkskip (its chunk-id lists, 32 faces a step) at (chunk, cap)
    = (8, 128), (16, 96), (32, 64) on the Morton-ordered face list with the
    original ids, bitwise equal to its plain version and to K1 by the tie
    rule, nothing dropped; at cap 4 chunks are dropped, the kept list is
    the full list's nearest prefix, and where the full render's winner is
    in that prefix it still wins;
 4j. the culled kernels on a sliver-heavy batch (b2, 224 px, 3000 random
    faces, a third of them slivers and near-degenerate faces along pixel
    rows, which the cull boxes leave unbounded): K1 at the default budget,
    padded and at a budget of 64 that drops chunks, K6 padded and at kept
    counts cut to 2 chunks (also against K3's coverage outputs), and K8,
    bitwise equal to their plain versions; K8 on a face that covers pixels
    through a barycentric rounded to -0 (its sign test must not reject
    them);
 5. the main path through `Predictor` at full width (three full
    MobileNetV3-minimal encoders, FLAME with 300 shape / 50 expression
    components on the full-size procedural head, batch 64, 224 px), random
    init, with the face recentred as bench.py's cam_fix does: coverage
    > 5 %, raster_overflow == 0, every output finite, K1's launch counter
    rose (K2 has no kernel left); then the padded layout's path
    (raster_compact=0); then the card's outputs against the port's plain
    CPU path on a small input;
 5b. the training path through `SmirkSystem.train_step` at full width (the
    training recipe's settings: generator 32 features / 5 ResNet blocks,
    mask ratio 0.01, dilation 10, Ke 1; teachers absent), b32, 224 px,
    fp32, bench.py's synthetic batch: 3 steps of each parity with finite
    metrics, zero raster overflow on both paths, the expression encoder
    and the generator moved, the pose and shape encoders not, and every
    step of each parity launched K1 (the cycle path's render), K3 and K4's
    fold, and neither K5 nor K4's store; then one step of each parity on
    the padded layout (K1b, K3b);
 5c. the op path through `smirk_tpu_torch.ops` at full width: FLAME from
    seeded parameters (300 shape / 50 expression components) on the
    recentred procedural head, its face region at b32, 224 px;
    `ops.rasterize` with D = 9 [gray albedo | world position | normal] at
    capacity 512, point shading with 2 lights and SH shading, an L2 loss
    to a seeded target and its gradient to the expression parameters:
    coverage > 5 %, every output and gradient finite, K6, K7 and K5
    launched and neither K3 nor K4 (either epilogue), no record list
    gathered on the forward (K6 reads
    the records through the bins), the values equal to
    `interpolate_attributes`,
    and the gradient to the face vertices and attributes within 1e-5 x the
    sum of the per-pixel terms' magnitudes of a dense gather-based
    autograd reference on the card; one more pass at capacity 384; then
    the coverage entry points `ops.rasterize_coverage` (K6) and
    `ops.rasterize_coverage_pallas` (K8) on the same faces;
 5d. the scheduled rasters' path: `rasterize_normals_fused(merged=True)`,
    `rasterize_normals_fused(sort_tiles=True)` and
    `rasterize_normals_chunkskip` (chunk 8, cap 128, Morton order) on the
    b64 faces of phase 4i: coverage > 5 %, every output finite, nothing
    dropped, K9, K10 and K11 launched, and pix_to_face against the
    default compact render by the tie rule;
 5e. the reconstruct path through `Predictor(use_generator=True)
    .reconstruct` at full width (the default Config, the generator at 32
    features / 5 ResNet blocks), b64: seeded 480x640 uint8 frames, each
    with the main path's 105 landmarks_mp mapped into it at the scale
    that makes the scale-1.4 crop 1.5 x 224 px (a downscale to 224 px),
    so that the hull covers the rendered face: every output finite,
    coverage > 5 %, no raster overflow, K1 launched and none of K3, K4 or
    K6; the masked image equal
    to the crop outside the dilated hull and the render and 0 inside,
    except at the hints; `SmirkSystem.reconstruct` on the card against the
    port's CPU run on 8 images with the same infer outputs and injected
    draws (masked images agreeing on >= 99.9 % of pixels, the
    reconstructions within 1e-4 on the images whose masks agree); the
    device's warp (1e-3 on the 0-255 scale) and hull (exactly) against the
    numpy copies; reconstruct_ms_batch / reconstruct_fps (5 windows of 5
    calls, host clock), the call split (crop + hull, infer, sampling +
    mask, generator, host copy-back) with CUDA events, the host's crop
    matrices and hulls on the host clock, the bytes copied in and out and
    the generator's FLOPs (forward hooks) and rate. It runs after the
    timings of phase 6, so that those run on the process state the phases
    before them leave;
 5f. the training CLI (`smirk_tpu_torch.cli.train.main`, in this process)
    at full width with --synthetic: the recipe's values as dotted overrides
    (no YAML file: the card's machine has no PyYAML), b32, one epoch of 4
    steps, a checkpoint every 2 steps, 8 loader workers, no image panels
    (no PIL there), the port's `assets.load_all` patched to the recentred
    procedural head: the loader alone (images/s, the card idle), then the
    CLI: every metrics.jsonl record finite, last_state.pt and model_0.pt
    written, every step launched K1, K3 and K4's fold and neither K5 nor
    K4's store (counts reset before each step), the CLI's steps/s beside
    [6]'s train_step time; `Predictor(checkpoint=model_0.pt)` at b64
    launches K1; a second run with SMIRK_FAULT_INJECT_STEP=3 salvages
    last_state.pt at step 3 and a third with resume_state= resumes there
    and finishes the epoch; two systems restored from the salvaged file
    take the same two steps within 1e-3 relative;
 5g. the bench line: `python -m smirk_tpu_torch.bench` as a child process
    under a deadline: a provisional line first, then a final line with
    every field finite and tf32 false, printed here;
 5h. F1: with both global TF32 flags True, `SmirkSystem.infer` at b64
    reads them False inside (a pre-hook) and equals a call with them False
    bitwise (within 1e-6 if cuDNN picks another algorithm, reported); the
    same call with the pin bypassed (TF32) differs by more; the globals
    read True after the pinned call; then, the globals False, the pin's own
    cost: pinned and bypassed infer in alternating windows. Phases 5f-5h
    run after 5e;
 5i. serving (after 5h), on the main path's system at b64: `serving.
    export_inference` on the card (its seconds, the artifact's bytes, K1's
    custom op once in the graph), `load_inference` (outputs bitwise equal
    to `SmirkSystem.infer`, also with both global TF32 flags True: the
    call's fp32 pin; K1 launched once a call; coverage > 5 %, no overflow;
    on a mismatch the first differing op of the two runs' op traces is
    printed), the artifact's call time beside [6]'s infer (5 windows of
    10, on host images and, alternating with infer, on the card's copy);
    `InferenceServer.predict` on a ragged 100-image request (two chunks,
    the tail trimmed); the HTTP daemon on a local port with one
    warm-up and three b64 /predict requests from a client thread: the
    round trip, images/s and its split (npz encode, the call, npz decode,
    the socket); `export_reconstruct` (generator 32 features / 5 blocks)
    bitwise equal to `SmirkSystem.reconstruct` on the same draws,
    deterministic per seed, its call time beside [5g]'s
    reconstruct_fp32_ms_batch; a 1-device `export_inference_sharded`
    equal to the plain artifact and a 2-device one refused on this host;
 5j. precision (after 5i): `arch.bf16_compute`'s train step at b32 on
    both parities (finite, no overflow, K1 / K3 / K4's fold launched by
    these steps, the render's inputs fp32, every convolution's input bf16
    but the generator's fp32 head) and one window of 3 steps with the
    host's CPU time beside [5g]'s; `arch.bf16_cycle_frozen`'s steps (the
    same gates); `train.remat_cycle`'s cycle loss, gradient and running
    statistics against the plain path on one state (cuDNN's deterministic
    algorithms; two plain reruns set the gradient's floor); the fp32,
    cycle_frozen and remat steps' times and peak memory from a child
    process (`python -m smirk_tpu_torch.bench --inner train_options`); the
    bf16 reconstruct finite; the bf16 artifact bitwise equal to bf16
    `infer`; the card against the CPU on 4 images at the bf16 rule, the
    card's bf16 moved from its fp32 (the mean over outputs);
 5k. the teachers: VGG16, the EMOCA ResNet50 and MICA at full depth from
    seeded files in the reference layouts, through the loaders, in a b32
    step at the recipes' weights (every teacher loss finite and nonzero),
    its time and its split into each teacher's forward and backward, the
    card against the CPU on a b2 `_loss1`;
 6. timings, warm, each beside the card's name and power limit: with CUDA
    events around back-to-back calls each kernel, its plain version, its
    library yardstick where
    there is one (K2's function: one advanced-index gather; K7: one
    scatter_add_ of prebuilt rows; K4's fold: one index_add_ of prebuilt
    moment rows by a prebuilt pixel-to-face index; its store: one
    scatter_add_; K5: one index_add_), K4's store epilogue and K5 at the
    training shapes beside, the kept counts
    that stand where K2 stood, K1 at b32 on the cycle path's faces, the op
    path's forward and backward, the coverage forward with its inputs
    (`_v3_impl`, b32, capacity 512), the whole calls of the five inference
    rasters (compact, padded, merged, sort_tiles, chunk-skip), the stages
    of infer (and K3 with its inputs, the training raster's forward) and of
    one train step, a torch.profiler trace of one train step per parity
    (device time by kernel class, busy share) and its convolution FLOPs;
    on the host clock the median and spread of 5 windows of 50 infer calls
    (ms/batch, images/s), of 3 windows of 20 Predictor calls and of 3
    windows of 5 train steps per parity; occupied chunks vs the budget;
    each kernel row's call on the device alone, 20 calls captured in one
    CUDA graph and replayed (a call shorter than its Python and launch
    costs, as K4's and K5's are, is paced by the host in the times above;
    a call that cannot be captured fails the run);
 7. a `kernels` JSON line (13 rows: K1, K1b, K2, K3, K3b, K4, K5, K6, K7, K8,
    K9, K10, K11; K2's row "folded into K1/K3 staging" with 0 launches;
    K1's launches those of the main path, of the reconstruct call and of
    the served calls of 5i, its `direct_ms` the launch without the custom
    op's dispatch;
    each row's `device_ms` beside its `ms`),
    with the rasters' bounds counted from this run's inputs as the work
    their function needs (the face-pixel pairs in the faces' boxes, the
    binned records read once; K9 and K10 take K1b's, K11 the records of
    every binned chunk, which it must read), the count of every slot
    against every pixel and the face-warp tests the culls of K1, K3, K6,
    K8, K10 and K11 (at each chunk size) keep printed beside them; K7's
    bound counts the slots, the payload rows of slots in [0, C) and the
    output, with the count that reads every row and the share of rows
    read beside it; K4's row is its fold
    epilogue's (the slots, g at the pixels with a live slot, the bins of
    the slots a live pixel reached, the face table), with the store's time,
    the count that reads every bin and the per-slot route's bound (K4 +
    K5) beside; K5's row is the op path's launch (the bins, the rows
    of slots that hold a face, the face table), with the every-row count
    and the training shapes' time beside;
 8. the last line, {"ok": true, "device": ...}.

The weights are random (seeded) and the FLAME assets are a procedural
stand-in (smirk_tpu_torch.assets.procedural_bundle) at FLAME's sizes.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth; used for each kernel's bound.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# ~fp32 operations of one face-pixel test: 4 affine forms x (2 mul + 2 add)
OPS_PER_FACE_PIXEL = 16
# K8's face-pixel test: 3 edge terms x (4 sub + 2 mul + 1 sub), 3
# divisions, the depth's 3 mul + 2 add
OPS_PER_FACE_PIXEL_K8 = 29
OP_B = 32  # the op path's batch: the training recipe's
# end-to-end timing: windows x calls per window
INFER_WINDOWS, INFER_CALLS = 5, 50
CALL_WINDOWS, CALL_CALLS = 3, 20
TRAIN_WINDOWS, TRAIN_STEPS = 3, 5
INFER_B = 64  # bench.py's inference batch
GRAPH_CALLS = 20  # calls a kernel row's CUDA graph replays for its device time
TRAIN_B = 32  # the training recipe's batch
# the reconstruct path: frames (H, W) the landmark crop downscales to 224 px,
# the crop's side in the frame over 224, the images the card is held
# against the CPU on, and its timing windows x calls
FRAME_HW = (480, 640)
CROP_OVER_S = 1.5
RECON_CPU_B = 8
RECON_WINDOWS, RECON_CALLS = 5, 5
# the training CLI (phase 5f): steps of its one epoch, loader workers, the
# loader probe's batches (two a worker: a worker collates whole batches,
# so an epoch of fewer keeps some idle), and the tolerance of two resumes
# from one checkpoint on the card (K4's fold and cuDNN's weight gradients
# may sum in another order); the bench line's deadline (phase 5g)
CLI_STEPS, CLI_WORKERS = 4, 8
PROBE_BATCHES = 2 * CLI_WORKERS
CLI_RESUME_RTOL = 1e-3
BENCH_DEADLINE_S = 420
# tolerances of the float-order-dependent checks: K4 and K5 within 1e-5 x
# the sum of the magnitudes of their terms; the end-to-end gradient within
# 1e-4 x its kappa^2-weighted magnitudes (rasterizer.dense_gradient_and_
# scale): a sum of n fp32 terms in any order is within n*u of their
# magnitudes (u = 2^-24), and a face's gradient sums up to ~1000 pixels
# here, 1000 u = 6e-5
SUM_RTOL = 1e-5
GRAD_RTOL = 1e-4


_T0 = time.perf_counter()


def log(*a):
    """Print and flush; a phase header ("[n] ...") gets the seconds since
    the script started."""
    if a and str(a[0]).startswith("["):
        a = (*a, f"(t={time.perf_counter() - _T0:.1f} s)")
    print(*a, flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call on the card, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_windows(fn, n_windows: int, n_calls: int) -> list:
    """Sorted ms per call of `n_windows` warm windows of `n_calls`
    back-to-back calls, each ended by a synchronize (host clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n_windows):
        t = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) / n_calls * 1e3)
    return sorted(ms)


def spread(ms: list) -> float:
    """(max - min) / median, in %."""
    return (ms[-1] - ms[0]) / statistics.median(ms) * 100


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def within(got, want, scale, what, rtol=SUM_RTOL):
    """Check every element of `got` within rtol * scale + 1e-30 of `want`
    -> (worst ratio |got - want| / (rtol * scale + 1e-30), max |got -
    want|)."""
    diff = (got.double() - want.double()).abs()
    ratio = float((diff / (rtol * scale.double() + 1e-30)).max())
    check(ratio <= 1.0, f"{what}: worst |diff| / ({rtol:g} x scale) = {ratio:.4g} <= 1")
    return ratio, float(diff.max())


def bound(ops, nbytes):
    """(bound ms, bound_by): the larger of ops at the fp32 peak and bytes at
    the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def raster_bound(win, n_tiles, n_out, n_planes, B, Tp, lanes=32):
    """(bound ms, bound_by) of a chunk-window raster: 16 fp32 operations per
    face-pixel test over the windows + 4 per value plane per pixel, against
    the windows, the records (`lanes` floats) they read once and n_out
    output arrays."""
    from smirk_tpu_torch.render import rasterizer as R

    ops = win * 32 * R.TILE_PIX * OPS_PER_FACE_PIXEL + \
        n_tiles * R.TILE_PIX * 4 * n_planes
    nbytes = 2 * B * Tp * 4 + win * 32 * lanes * 4 + n_out * B * Tp * R.TILE_PIX * 4
    return bound(ops, nbytes)


def culled_work(kept, bins, raw, image_size, boxes=None):
    """The work of a binned raster (K1, K3, K6, K8) on these inputs, counted
    on the host from the inputs (no device counter) -> dict: chunk_steps
    (sum of kept), box_pairs ((face, pixel) pairs of a walked face and a
    pixel of its tile whose centre lies in the face's bounding box `raw`),
    binned_faces (distinct faces in the walked chunks, summed over images)
    and, given a kernel's cull boxes `boxes`, warp_tests_all (32 x chunk
    steps x 8 warps: every face slot for every warp, the unculled walk) and
    warp_tests_kept (face-warp tests the cull keeps: a real face whose cull
    box widened by one pixel meets the warp's 16x8 rectangle)."""
    import torch
    from smirk_tpu_torch.render import rasterizer as R

    B, Tp, C = bins.shape
    F = raw.shape[1]
    dev = bins.device
    _, tx = R._tile_grid(image_size)
    real = (torch.arange(C, device=dev) < kept[..., None] * R.V3_CHUNK) & (bins >= 0)
    ids = bins.clamp_min(0).long()
    bidx = torch.arange(B, device=dev)[:, None, None]
    t = torch.arange(Tp, device=dev)
    c0 = ((t % tx) * R.TILE_COLS).float()[None, :, None]  # (1,Tp,1)
    r0 = ((t // tx) * R.TILE_ROWS).float()[None, :, None]
    rb = raw[bidx, ids]  # (B,Tp,C,4)
    ncol = (torch.minimum(rb[..., 1].floor(), c0 + R.TILE_COLS - 1)
            - torch.maximum(rb[..., 0].ceil(), c0) + 1).clamp_min(0)
    nrow = (torch.minimum(rb[..., 3].floor(), r0 + R.TILE_ROWS - 1)
            - torch.maximum(rb[..., 2].ceil(), r0) + 1).clamp_min(0)
    seen = torch.zeros((B, F + 1), device=dev)
    seen.scatter_(1, torch.where(real, ids, F).reshape(B, -1), 1.0)
    steps = int(kept.sum())
    work = {"chunk_steps": steps, "box_pairs": int((ncol * nrow)[real].sum()),
            "binned_faces": int(seen[:, :F].sum())}
    if boxes is not None:
        wc0 = c0[..., None] + 16.0 * torch.arange(8, device=dev)  # (1,Tp,1,8)
        bb = boxes[bidx, ids][..., None]  # (B,Tp,C,4,1)
        meet = ~((bb[..., 1, :] + 1 < wc0) | (bb[..., 0, :] - 1 > wc0 + 15)
                 | (bb[..., 3, :] + 1 < r0[..., None]) | (bb[..., 2, :] - 1 > r0[..., None] + 7))
        work["warp_tests_all"] = steps * R.V3_CHUNK * 8
        work["warp_tests_kept"] = int((meet & real[..., None]).sum())
    return work


def chunk_work(counts, clist, records, face_verts, chunk, image_size):
    """K11's work on its inputs (`chunkskip_inputs`), as `culled_work`
    counts it: its chunk lists laid out as the kernel stages them, 32 faces
    a step (slot f of step c the face f % chunk of list entry c * 32 /
    chunk + f / chunk), its cull boxes `cull_boxes` of the padded faces with
    the padding faces' (id -1) empty, as the kernel stages them."""
    import torch
    from smirk_tpu_torch.render import rasterizer as R

    B, Tp, cap = clist.shape
    entry = torch.arange(cap, device=clist.device)[:, None]
    ids = clist[..., None] * chunk + torch.arange(chunk, device=clist.device)
    ids = torch.where(entry < counts[..., None, None], ids, -1).reshape(B, Tp, cap * chunk)
    pad = (-cap * chunk) % R.V3_CHUNK
    if pad:
        ids = torch.cat([ids, ids.new_full((B, Tp, pad), -1)], dim=2)
    raw = torch.stack(R._bbox_and_priority(face_verts, image_size)[:4], -1)
    empty = torch.tensor([math.inf, -math.inf, math.inf, -math.inf], device=clist.device)
    boxes = torch.where((records[..., 12] < 0)[..., None], empty,
                        R.cull_boxes(face_verts, image_size))
    kept = (counts * chunk + R.V3_CHUNK - 1) // R.V3_CHUNK
    return culled_work(kept, ids, raw, image_size, boxes)


def kept_share(work) -> str:
    """The face-warp tests a cull keeps, of 32 x chunk steps x 8 warps."""
    return (f"{work['warp_tests_kept']} of {work['warp_tests_all']} (32 x chunk steps x 8 "
            f"warps, {work['warp_tests_kept'] / max(1, work['warp_tests_all']) * 100:.1f} %)")


def culled_bound(work, n_tiles, n_out, n_planes, rec_bytes=128,
                 ops_per_pair=OPS_PER_FACE_PIXEL):
    """(bound ms, bound_by) of a binned raster's function on these inputs:
    ops_per_pair operations per (face, pixel) pair whose pixel centre lies
    in the face's bounding box, + 4 per value plane per pixel, against the
    bytes read once (the rec_bytes of each binned face, the walked chunks'
    bin ids, one count per tile) and the n_out outputs written once."""
    ops = work["box_pairs"] * ops_per_pair + n_tiles * 1024 * 4 * n_planes
    nbytes = (work["binned_faces"] * rec_bytes + work["chunk_steps"] * 32 * 4
              + n_tiles * 4 + n_out * n_tiles * 1024 * 4)
    return bound(ops, nbytes)


def tie_mismatches(p2f_a, p2f_b, zb_a, zb_b, fv, size):
    """tests/test_torch_raster.py's check_p2f_zbuf on the card: pix_to_face
    equal except at pixels where an edge of one of the two candidate faces
    passes through the pixel centre, or both are there at equal depth,
    within 8u of the magnitudes rounded (float64 edge terms); at most 0.1 %
    of pixels differ; zbuf equal where uncovered and within 8u of the
    winner's depth magnitudes where both agree. -> mismatch count."""
    import torch

    rounding = 8 * 2.0 ** -24
    fv = fv.double()
    c = (2 * torch.arange(size, device=fv.device, dtype=torch.float64) + 1 - size) / size
    x, y = c[None, None, :], c[None, :, None]
    b = torch.arange(fv.shape[0], device=fv.device)[:, None, None]

    def interp(p2f):
        f = fv[b, p2f.clamp_min(0).long()]  # (B,H,W,3,3)
        X, Y, Z = f[..., 0], f[..., 1], f[..., 2]
        es, ss = [], []
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            a, bb = Y[..., j] - Y[..., k], X[..., k] - X[..., j]
            p, q = X[..., j] * Y[..., k], Y[..., j] * X[..., k]
            es.append(a * x + bb * y + p - q)
            ss.append((a * x).abs() + (bb * y).abs() + p.abs() + q.abs())
        e, s = torch.stack(es, -1), torch.stack(ss, -1)
        denom = e.sum(-1)
        safe = torch.where(denom == 0, 1.0, denom)
        z = (e * Z).sum(-1) / safe
        return e, s, z, (s * Z.abs()).sum(-1) / safe.abs() + z.abs()

    same = p2f_a == p2f_b
    cov = same & (p2f_a >= 0)
    check(torch.equal(zb_a[same & ~cov], zb_b[same & ~cov]), "zbuf equal where uncovered")
    ea, sa, za, zsa = interp(p2f_a)
    eb, sb, zb, zsb = interp(p2f_b)
    zerr = (zb_a.double() - zb_b.double()).abs()
    check(bool((zerr[cov] <= rounding * zsa[cov]).all()),
          f"zbuf within 8u of its magnitudes where pix_to_face agrees (max |dz| "
          f"{float(zerr[cov].max()):.3g})")
    edge_a = (ea.abs() <= rounding * sa).any(-1) & (p2f_a >= 0)
    edge_b = (eb.abs() <= rounding * sb).any(-1) & (p2f_b >= 0)
    ztie = (p2f_a >= 0) & (p2f_b >= 0) & ((za - zb).abs() <= rounding * (zsa + zsb))
    bad = int((~same).sum())
    check(bool((same | edge_a | edge_b | ztie).all()),
          f"the {bad} differing pixels are edge or depth ties")
    check(bad <= 1e-3 * p2f_a.numel(), f"{bad} differing pixels <= 0.1 %")
    return bad


def sliver_faces(dev, S, B=2, F=3000):
    """(B,F,3,3) faces, (B,F,3,3) normals on S px images (seeded): random
    faces of 0.3 to 16 px, a third of them replaced by slivers and
    near-degenerate faces along pixel rows (tests/test_torch_cuda_kernels.py's
    sliver batch)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    p0 = rng.uniform(-10, S + 10, (B, F, 1, 2))
    pts = p0 + rng.normal(size=(B, F, 3, 2)) * 10 ** rng.uniform(-0.5, 1.2, (B, F, 1, 1))
    sl = rng.random((B, F)) < 1 / 3
    base = np.concatenate([p0[..., 0], np.round(p0[..., 1])], -1)  # on a pixel row
    length = rng.uniform(0.2, 30.0, (B, F, 1))
    off = 10 ** rng.uniform(-9, -1, (B, F, 1))
    t = rng.uniform(-0.5, 1.5, (B, F, 1))
    sliver = np.stack([base, base + np.concatenate([length, 0 * length], -1),
                       base + np.concatenate([t * length, off], -1)], 2)
    xy = (2.0 * np.where(sl[..., None, None], sliver, pts) - S + 1.0) / S
    fv = torch.tensor(np.concatenate([xy, rng.uniform(9, 11, (B, F, 3, 1))], -1),
                      dtype=torch.float32, device=dev)
    return fv, torch.tensor(rng.normal(size=(B, F, 3, 3)), dtype=torch.float32, device=dev)


# kernel-name fragments -> class, first match wins (for the train profile)
KERNEL_CLASSES = (
    ("port kernels K1, K3-K11", ("raster_fused", "raster_planes",
                             "segment_moments", "fold_faces", "raster_coverage",
                             "segment_reduce", "raster_bins", "raster_groups",
                             "raster_chunkskip")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft",
                     "wgrad", "dgrad", "nchw", "nhwc")),
    ("matmul", ("gemm", "cutlass", "ampere", "sm90")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce", "welford", "var_mean", "norm")),
    ("scatter / gather / index", ("scatter", "gather", "index", "topk", "sort",
                                  "radix", "cumsum", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill",
                     "where", "clamp", "pool")),
)


def profile_train_step(system, batch, parity, gen):
    """One warm train step under torch.profiler -> (wall ms, {class: device
    ms}), or None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system.train_step(batch, parity, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        system.train_step(batch, parity, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_class = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = e.key.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    return (wall, by_class) if sum(by_class.values()) > 0 else None


def conv_flops_of_step(system, batch, parity, gen):
    """Convolution FLOPs (2 per multiply-add) of one train step, counted by
    forward hooks on every Conv2d / ConvTranspose2d of the encoder and the
    generator: each call's forward, plus one forward's worth for the input
    gradient and one for the weight gradient where autograd takes them."""
    return conv_flops((system.encoder, system.generator),
                      lambda: system.train_step(batch, parity, gen))


def conv_flops(modules, fn):
    """Convolution FLOPs of fn(), counted as `conv_flops_of_step` says on
    the convolutions of `modules`."""
    import torch

    total = [0.0]

    def hook(m, inp, out):
        x = inp[0]
        k = m.weight.shape[2] * m.weight.shape[3]
        if isinstance(m, torch.nn.ConvTranspose2d):
            fwd = 2.0 * x.numel() * (m.out_channels // m.groups) * k
        else:
            fwd = 2.0 * out.numel() * (m.in_channels // m.groups) * k
        grads = torch.is_grad_enabled() and (x.requires_grad or m.weight.requires_grad)
        total[0] += fwd * (1 + (grads and x.requires_grad) + (grads and m.weight.requires_grad))

    handles = [m.register_forward_hook(hook)
               for mod in modules for m in mod.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def train_stages(system, batch, parity, gen):
    """CUDA-event ms of one train step's stages: phase-1 forward, phase-1
    backward + both Adam steps, phase 2 (forward, backward, Adam)."""
    import torch

    bt = system._batch(batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss1, aux = system._loss1(bt, True, gen)
    ev[1].record()
    system._update_path1(loss1)
    ev[2].record()
    system._phase2(bt, aux["encoder_output"], aux["transformed_vertices"], parity, gen)
    ev[3].record()
    torch.cuda.synchronize()
    system._eval_mode()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def reconstruct_phase(bundle, encoder_state, out, B, S, card):
    """Phase 5e: the reconstruct path at full width on the main path's
    encoder weights and landmarks (`out`, the main path's outputs) ->
    the kernels' launch counts of one Predictor.reconstruct call."""
    import numpy as np
    import torch

    from smirk_tpu_torch import Predictor
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.data import transforms as T
    from smirk_tpu_torch.masking import masking as masking_lib
    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train.trainer import SmirkSystem

    FH, FW = FRAME_HW
    log(f"[5e] reconstruct path: Predictor(use_generator=True).reconstruct at b{B}, "
        f"{FH}x{FW} uint8 frames -> {S} px crops, fp32, generator 32 features / 5 blocks")
    pred_rec = Predictor(use_generator=True, bundle=bundle)  # the card
    sys_rec = pred_rec.system
    sys_rec.encoder.load_state_dict(encoder_state)
    dev = sys_rec.device
    n_upper, _ = sys_rec._reconstruct_budget()
    # seeded frames; each frame's landmarks are the main path's 105
    # landmarks_mp (NDC) mapped into the frame about its centre, at the
    # scale that makes the 1.4 x bbox crop CROP_OVER_S x 224 px: the crop is
    # a downscale and the hull covers the rendered face
    frames = np.random.default_rng(5).integers(0, 256, (B, FH, FW, 3), dtype=np.uint8)
    lmk_ndc = out["landmarks_mp"][..., :2]
    bbox = np.ptp(lmk_ndc, axis=1).mean() * S / 2  # mean side in the render's pixels
    lmk_scale = CROP_OVER_S * S / (1.4 * bbox)
    lmks = lmk_ndc * (S / 2 * lmk_scale) + np.float32([FW / 2, FH / 2])
    tforms, kpts = T.crop_tforms(lmks, S)
    crop_side = (S - 1) / np.hypot(tforms[:, 0, 0], tforms[:, 0, 1])
    log(f"    {lmks.shape[1]} landmarks a frame, the render's at x{lmk_scale:.3f}; crop "
        f"side {crop_side.min():.1f}-"
        f"{crop_side.max():.1f} px of the frame -> {S} px")
    check(crop_side.min() > S, "the crop is a downscale")
    R.reset_launch_counts()
    rec = pred_rec.reconstruct(frames, lmks, seed=0)
    torch.cuda.synchronize()
    rec_launches = {k.__name__: k.launches for k in R.KERNELS}
    log(f"    launches on the reconstruct path: {rec_launches}")
    check(rec_launches["raster_fused_windows"] > 0 and all(
        rec_launches[k.__name__] == 0 for k in (
            R.raster_planes_windows, R.segment_moments_to_faces, R.segment_moments,
            R.raster_coverage_windows)),
        "the reconstruct path launched K1, and none of K3, K4 (either epilogue) or K6")
    for k, v in rec.items():
        check(np.isfinite(v).all(), f"{k} {v.shape} finite")
    for k in ("cropped_img", "masked_img", "reconstructed_img", "rendered_img"):
        check(rec[k].shape == (B, S, S, 3), f"{k} shape {(B, S, S, 3)}")
    cov_r = float(rec["rendered_mask"].mean())
    check(cov_r > 0.05, f"reconstruct render coverage {cov_r:.4f} > 0.05")
    check(int(rec["raster_overflow"].max()) == 0, "reconstruct raster_overflow == 0")
    # outside the dilated hull and the render the masked image is the crop,
    # inside it is 0, except where a hint landed (at most n_upper a image)
    with torch.inference_mode():
        hull_r = T.convex_hull_mask(kpts, (S, S), dev)[..., None]
        hole = ((1 - masking_lib._dilate(1 - hull_r, sys_rec.config.train.mask_dilation_radius))
                * (1 - torch.from_numpy(rec["rendered_mask"]).to(dev))).cpu().numpy()[..., 0]
    outside = hole == 1
    hinted = np.where(outside, (rec["masked_img"] != rec["cropped_img"]).any(-1),
                      (rec["masked_img"] != 0).any(-1)).sum((1, 2))
    check(hinted.max() <= n_upper and hinted.sum() > 0,
          f"masked == crop outside the dilated hull and the render, 0 inside, but at "
          f"the hints ({int(hinted.min())}-{int(hinted.max())} pixels a image <= "
          f"{n_upper}); {outside.mean() * 100:.1f} % of pixels outside")
    hull_share = float(1 - hull_r.mean())
    log(f"    the hull covers {hull_share * 100:.1f} % of the crop")

    log(f"    SmirkSystem.reconstruct on the card vs the port's CPU run: {RECON_CPU_B} "
        "images, the same infer outputs and injected draws")
    NC = RECON_CPU_B
    with torch.inference_mode():
        imgs_c, kpts_c = pred_rec._crop(frames[:NC], lmks[:NC])
        hull_c = T.convex_hull_mask(kpts_c, (S, S), dev)[..., None]
        out_c = sys_rec.infer(imgs_c)
        g_c = torch.Generator(device=dev).manual_seed(3)
        draws_c = {
            "u": torch.rand((NC, n_upper), generator=g_c, device=dev),
            "bary": masking_lib.random_barycentric((NC, n_upper), g_c, dev),
            "rsing": torch.randint(0, 2, (NC,), generator=g_c, device=dev) * 2 - 1,
            "rscale": torch.rand((NC,), generator=g_c, device=dev),
            "noise": torch.randn((NC, S, S, 3), generator=g_c, device=dev),
            "drop_centers": torch.bernoulli(torch.full((NC, S, S, 1), 0.01, device=dev),
                                            generator=g_c),
        }
        m_card, r_card = sys_rec.reconstruct(out_c, imgs_c, hull_c, draws=draws_c)
    sys_cpu = SmirkSystem(Config(), bundle, device="cpu")
    sys_cpu.encoder.load_state_dict(sys_rec.encoder.state_dict())
    sys_cpu.generator.load_state_dict(sys_rec.generator.state_dict())

    def to_cpu(d):
        return {k: v.cpu() for k, v in d.items()}

    m_cpu, r_cpu = sys_cpu.reconstruct(to_cpu(out_c), imgs_c.cpu(), hull_c.cpu(),
                                       draws=to_cpu(draws_c))
    px_agree = ((m_card.cpu() - m_cpu).abs() <= 1e-6).all(-1)
    img_agree = px_agree.all(-1).all(-1)
    check(float(px_agree.float().mean()) >= 0.999 and bool(img_agree.any()),
          f"masked images agree (1e-6) on {float(px_agree.float().mean()) * 100:.4f} % >= "
          f"99.9 % of pixels; {int(img_agree.sum())} of {NC} images wholly")
    rec_err = float((r_card.cpu() - r_cpu)[img_agree].abs().max())
    check(rec_err <= 1e-4, f"reconstructed_img card vs cpu max |diff| {rec_err:.2e} <= 1e-4 "
          "on the images whose masks agree")

    log("    the device's warp and hull against the numpy copies on the same frames")
    with torch.inference_mode():
        w_card = T.warp_affine(torch.from_numpy(frames).to(dev).float(), tforms,
                               (S, S)).cpu().numpy()
        h_card = T.convex_hull_mask(kpts, (S, S), dev).cpu().numpy()
    w_np = np.stack([T.warp_affine_np(f.astype(np.float32), m, (S, S))
                     for f, m in zip(frames, tforms)])
    warp_err = float(np.abs(w_card - w_np).max())
    check(warp_err <= 1e-3, f"warp card vs numpy max |diff| {warp_err:.2e} <= 1e-3 (0-255)")
    h_np = np.stack([T.convex_hull_mask_np(k, (S, S)) for k in kpts])
    check(np.array_equal(h_card, h_np), f"hull masks card == numpy ({B} images)")

    rec_w = timed_windows(lambda: pred_rec.reconstruct(frames, lmks), RECON_WINDOWS,
                          RECON_CALLS)
    rec_ms = statistics.median(rec_w)

    def split_once():
        """Predictor.reconstruct's steps with CUDA events between them."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        imgs_s, kp_s = pred_rec._crop(frames, lmks)
        hull_s = T.convex_hull_mask(kp_s, (S, S), dev)[..., None]
        ev[1].record()
        out_s = sys_rec.infer(imgs_s)
        ev[2].record()
        masked_s = sys_rec.masked_input(out_s, imgs_s, hull_s,
                                        torch.Generator(device=dev).manual_seed(0))
        ev[3].record()
        with torch.inference_mode():
            recon_s = sys_rec.generator(torch.cat([out_s["rendered_img"], masked_s], -1))
        ev[4].record()
        pred_rec._to_numpy({"cropped_img": imgs_s, **out_s, "masked_img": masked_s,
                            "reconstructed_img": recon_s})
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    split_once()
    splits = [split_once() for _ in range(5)]
    split_names = ("crop_hull", "infer", "sampling_mask", "generator", "host_copy_back")
    split_med = {n: statistics.median(s[i] for s in splits) for i, n in enumerate(split_names)}
    # inside crop_hull: the host's crop matrices and hulls (host clock)
    host_ms = {"crop_matrices": [], "hulls": []}
    for _ in range(5):
        t = time.perf_counter()
        _, kp_h = T.crop_tforms(lmks, S)
        host_ms["crop_matrices"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        [T._hull_of(k) for k in kp_h]
        host_ms["hulls"].append((time.perf_counter() - t) * 1e3)
    host_med = {k: statistics.median(v) for k, v in host_ms.items()}
    gen_flops = conv_flops((sys_rec.generator,), lambda: pred_rec.reconstruct(frames, lmks))
    gen_tflops_s = gen_flops / split_med["generator"] / 1e9
    bytes_in = frames.nbytes
    bytes_out = sum(v.nbytes for v in rec.values())
    log(f"    reconstruct_ms_batch{B} median {rec_ms:.3f} over {RECON_WINDOWS} windows of "
        f"{RECON_CALLS} calls (min {rec_w[0]:.3f}, max {rec_w[-1]:.3f}, spread "
        f"{spread(rec_w):.1f} %)  reconstruct_fps {B / rec_ms * 1e3:.1f} {card}")
    log(f"    reconstruct call split (CUDA events, median of 5, ms): " + ", ".join(
        f"{n} {v:.3f}" for n, v in split_med.items())
        + f"; sum {sum(split_med.values()):.3f} {card}")
    log(f"    inside crop_hull, host clock (median of 5): crop matrices "
        f"{host_med['crop_matrices']:.3f} ms, hulls {host_med['hulls']:.3f} ms; the call "
        f"copies {bytes_in / 1e6:.1f} MB in and {bytes_out / 1e6:.1f} MB out")
    log(f"    generator: {gen_flops / 1e12:.4f} TFLOP a batch (forward hooks) in "
        f"{split_med['generator']:.3f} ms = {gen_tflops_s:.2f} TFLOP/s, "
        f"{gen_tflops_s / (PEAK_FP32_FLOPS / 1e12) * 100:.1f} % of the fp32 peak {card}")
    log("    " + json.dumps({"reconstruct_ms_batch": rec_ms,
                             "reconstruct_fps": B / rec_ms * 1e3,
                             "reconstruct_batch": B,
                             "reconstruct_spread_pct": spread(rec_w),
                             "split_ms": split_med, "host_ms": host_med,
                             "generator_tflop": gen_flops / 1e12,
                             "bytes_in": bytes_in, "bytes_out": bytes_out}))
    return rec_launches


def train_cli_phase(bundle, images, S, train_ms, card):
    """Phase 5f: `smirk_tpu_torch.cli.train.main` in this process at full
    width (the recipe's values as dotted overrides, no YAML: the card's
    machine has no PyYAML), --synthetic, b32, 4 steps, 8 loader workers (a
    loader starts no more workers than its epoch has batches), the port's
    `assets.load_all` patched to the recentred procedural head, and one
    direct `make_visualizations` (the machine has no PIL to write the
    grid) -> {"loader_images_s", "cli_steps_s", "launches"} (K1, K3 and
    K4's fold summed over the steps)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from smirk_tpu_torch import Predictor, assets
    from smirk_tpu_torch.api import load_checkpoint
    from smirk_tpu_torch.bench import train_batch
    from smirk_tpu_torch.cli import train as train_cli
    from smirk_tpu_torch.config import load_config
    from smirk_tpu_torch.data.pipeline import load_dataloaders
    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train.trainer import SmirkSystem
    from smirk_tpu_torch.utils import checkpoint as ckpt

    log(f"[5f] training CLI: smirk_tpu_torch.cli.train --synthetic at b{TRAIN_B}, {S} px, "
        f"fp32, generator 32 features / 5 blocks, cycle on, {CLI_WORKERS} loader workers")
    root = tempfile.mkdtemp(prefix="smirk_cli_")
    recipe = {"image_size": S, "arch.num_shape": 300, "arch.num_expression": 50,
              "arch.enable_fuse_generator": True, "train.mask_ratio": 0.01,
              "train.mask_dilation_radius": 10, "train.Ke": 1,
              "train.loss_weights.cycle_loss": 1.0, "train.batch_size": TRAIN_B,
              "train.samples_per_epoch": CLI_STEPS * TRAIN_B, "train.num_epochs": 1,
              "train.ckpt_every_steps": 2, "train.num_workers": CLI_WORKERS,
              "train.visualize_every": 0, "train.save_every": 1,
              "train.log_losses_every": 1}

    def args(logdir, **extra):
        return ["--synthetic"] + [f"{k}={v}" for k, v in
                                  dict(recipe, **{"train.log_path": logdir}, **extra).items()]

    def records(logdir):
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    steps = []
    step_fn, load_all = SmirkSystem.train_step, assets.load_all

    def counted_step(self, *a, **kw):
        R.reset_launch_counts()
        out = step_fn(self, *a, **kw)
        torch.cuda.synchronize()
        steps.append({k.__name__: k.launches for k in R.KERNELS})
        return out

    SmirkSystem.train_step = counted_step
    assets.load_all = lambda *a, **kw: bundle
    try:
        # the loader alone, the card idle: a warm epoch of PROBE_BATCHES
        # (two a worker), then a timed one
        config = load_config(None, tuple(args(os.path.join(root, "probe"))[1:]))
        synth_len = os.environ.get("SMIRK_SYNTH_LEN")
        os.environ["SMIRK_SYNTH_LEN"] = str(PROBE_BATCHES * TRAIN_B)
        try:
            loader, _ = load_dataloaders(config, synthetic=True, pin_memory=True)
        finally:
            if synth_len is None:
                del os.environ["SMIRK_SYNTH_LEN"]
            else:
                os.environ["SMIRK_SYNTH_LEN"] = synth_len
        for _ in loader:  # spawns the workers and warms them
            pass
        t = time.perf_counter()
        n_img = sum(int(b["img"].shape[0]) for b in loader)
        loader_s = time.perf_counter() - t
        loader_ips = n_img / loader_s
        del loader
        log(f"    the loader alone: {n_img} images in {loader_s:.3f} s = {loader_ips:.1f} "
            f"images/s ({CLI_WORKERS} workers, {PROBE_BATCHES} batches, the card idle; "
            f"{CLI_WORKERS * 1e3 / loader_ips:.1f} ms a sample a worker); a b{TRAIN_B} step "
            f"needs {TRAIN_B / (train_ms[0] / 1e3):.1f} (p0) / "
            f"{TRAIN_B / (train_ms[1] / 1e3):.1f} (p1) images/s at [6]'s train_step times "
            f"{train_ms[0]:.3f} / {train_ms[1]:.3f} ms {card}")

        run1 = os.path.join(root, "run1")
        t = time.perf_counter()
        train_cli.main(args(run1))
        cli_s = time.perf_counter() - t
        recs = records(run1)
        check(all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float)),
              f"every metrics.jsonl record finite ({len(recs)} records)")
        train_recs = [r for r in recs if r["phase"] == "train"]
        check([r["global_step"] for r in train_recs] == list(range(1, CLI_STEPS + 1)),
              f"{CLI_STEPS} train steps logged")
        for f in ("last_state.pt", "model_0.pt", "config.json"):
            check(os.path.isfile(os.path.join(run1, f)), f"{f} written")
        check(len(steps) == CLI_STEPS and all(
            all(st[k.__name__] > 0 for k in (R.raster_fused_windows, R.raster_planes_windows,
                                             R.segment_moments_to_faces))
            and st["fold_slots_to_faces"] == 0 and st["segment_moments"] == 0
            for st in steps),
            f"every CLI step launched K1, K3 and K4's fold, and neither K5 nor K4's store "
            f"({steps[0]})")
        launches = {k: sum(st[k] for st in steps) for k in steps[0]}
        t_steps = [r["t"] for r in train_recs]
        cli_sps = (len(t_steps) - 1) / max(t_steps[-1] - t_steps[0], 1e-9)
        log(f"    the CLI: {CLI_STEPS} steps + 2 val batches + 3 checkpoint saves in "
            f"{cli_s:.3f} s (worker spawn and set-up included; {CLI_STEPS} train and 2 val "
            f"workers for the epoch's batches); steps 1 -> {CLI_STEPS} at "
            f"{cli_sps:.3f} steps/s ({1e3 / cli_sps:.1f} ms a step, a checkpoint save "
            f"inside) against [6]'s train_step {train_ms[0]:.3f} / {train_ms[1]:.3f} ms {card}")

        pred = Predictor(checkpoint=os.path.join(run1, "model_0.pt"), bundle=bundle)
        R.reset_launch_counts()
        out = pred(images)
        torch.cuda.synchronize()
        check(R.raster_fused_windows.launches > 0 and all(
            np.isfinite(v).all() for v in out.values()),
            f"Predictor(checkpoint=model_0.pt) at b{images.shape[0]}: K1 launched, every "
            "output finite")
        enc_file, _ = load_checkpoint(os.path.join(run1, "model_0.pt"))
        check(all(torch.equal(v.cpu(), enc_file[k])
                  for k, v in pred.system.encoder.state_dict().items()),
              "the Predictor's encoder is model_0.pt's")
        del pred

        run2 = os.path.join(root, "run2")
        os.environ["SMIRK_FAULT_INJECT_STEP"] = "3"
        try:
            train_cli.main(args(run2))
            raise AssertionError("the fault at step 3 did not fire")
        except RuntimeError as e:
            check("SMIRK_FAULT_INJECT_STEP=3" in str(e), f"run 2 crashed: {e}")
        finally:
            del os.environ["SMIRK_FAULT_INJECT_STEP"]
        salvaged = os.path.join(run2, "last_state.pt")
        check(torch.load(salvaged, weights_only=True)["step"] == 3,
              "run 2 salvaged last_state.pt at step 3")
        saved_copy = os.path.join(root, "salvaged.pt")
        shutil.copyfile(salvaged, saved_copy)

        train_cli.main(args(run2, resume_state=saved_copy))
        resumed = [r["global_step"] for r in records(run2)
                   if r["phase"] == "train" and r["global_step"] > 3]
        check(resumed == list(range(4, 4 + CLI_STEPS)),
              f"run 3 resumed at step 3 and finished the epoch (steps {resumed})")
        check(torch.load(salvaged, weights_only=True)["step"] == 3 + CLI_STEPS,
              f"run 3's last_state.pt at step {3 + CLI_STEPS}")

        # the resume on the card: two systems restored from the salvaged file
        # take the same two steps on one batch; K4's fold and cuDNN's weight
        # gradients may sum in another order, so within CLI_RESUME_RTOL
        batch = train_batch(TRAIN_B, S, 1)
        runs = []
        for _ in range(2):
            s_ = SmirkSystem(config, bundle)
            ckpt.restore_state(s_, saved_copy)
            steps_ = [s_.train_step(batch, p) for p in (3, 4)]
            runs.append([m for m, _ in steps_])
        worst = max(abs(a[k] - b[k]) / (abs(b[k]) + 1e-6)
                    for a, b in zip(*runs) for k in b)
        check(worst <= CLI_RESUME_RTOL,
              f"two restores of the salvaged state, two steps each: metrics within "
              f"{CLI_RESUME_RTOL:g} relative (worst {worst:.3g})")
        # the visualizations of the cycle step (parity 3: the generator
        # frozen), as visualize_every would draw them
        viz = s_.make_visualizations(batch, steps_[0][1])
        torch.cuda.synchronize()
        panels = {k: tuple(v.shape) for k, v in viz.items() if v is not None}
        check(all(bool(torch.isfinite(v).all()) for v in viz.values() if v is not None)
              and "2nd_path" in panels and "rendered_img_base" in panels,
              f"make_visualizations: every panel finite ({panels})")
        del s_, steps_, viz
        return {"loader_images_s": loader_ips, "cli_steps_s": cli_sps, "launches": launches}
    finally:
        SmirkSystem.train_step = step_fn
        assets.load_all = load_all
        shutil.rmtree(root, ignore_errors=True)


def bench_phase(card):
    """Phase 5g: `python -m smirk_tpu_torch.bench` as a child process ->
    its final line (checked: a provisional line first, every field present
    and finite, tf32 false)."""
    import os

    import torch

    from smirk_tpu_torch.bench import FIELDS, WORKLOADS

    log(f"[5g] the bench line: python -m smirk_tpu_torch.bench (deadline "
        f"{BENCH_DEADLINE_S} s)")
    torch.cuda.empty_cache()
    env = dict(os.environ, SMIRK_BENCH_DEADLINE_S=str(BENCH_DEADLINE_S))
    proc = subprocess.run([sys.executable, "-m", "smirk_tpu_torch.bench"], capture_output=True,
                          text=True, env=env, timeout=BENCH_DEADLINE_S + 30,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) >= 2 and lines[0].get("provisional") is True,
          "the bench printed a provisional line first")
    final = lines[-1]
    if proc.returncode != 0:
        log(proc.stderr[-2000:])
    fields = [f for w in WORKLOADS for f in FIELDS[w]]
    check(proc.returncode == 0 and final["provisional"] is False and all(
        isinstance(final.get(f), (int, float)) and math.isfinite(final[f]) for f in fields),
        f"the bench's final line has every field finite (rc {proc.returncode})")
    check(final["tf32"] is False, "the bench line reads tf32: false")
    log("    bench line: " + json.dumps(final))
    return final


def f1_phase(system, img):
    """Phase 5h: F1 on the card. With both global TF32 flags True,
    `SmirkSystem.infer` equals (bitwise) a call with them False; the same
    call with the pin bypassed runs TF32 and differs by more; the globals
    read True after the pinned call."""
    import torch

    from smirk_tpu_torch.train.trainer import SmirkSystem

    log(f"[5h] F1: SmirkSystem.infer at b{img.shape[0]} with the global TF32 flags "
        "True vs False; the pin bypassed")
    keys = ("expression_params", "shape_params", "vertices", "rendered_img")

    def flags(v):
        torch.backends.cudnn.allow_tf32 = v
        torch.backends.cuda.matmul.allow_tf32 = v

    seen = []
    hook = system.encoder.register_forward_pre_hook(lambda m, a: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    try:
        flags(False)
        off = system.infer(img)
        flags(True)
        seen.clear()
        on = system.infer(img)
        check(seen == [(False, False)], f"inside the pinned call both flags read False ({seen})")
        check((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
              == (True, True), "the globals read True after the pinned call")
        unpinned = SmirkSystem.infer.__wrapped__(system, img)  # fp32_math bypassed
        torch.cuda.synchronize()
        d_pin = max(float((on[k] - off[k]).abs().max()) for k in keys)
        if all(torch.equal(on[k], off[k]) for k in keys):
            log(f"  ok: infer with the globals True == with them False, bitwise "
                f"({', '.join(keys)})")
        else:  # cuDNN chose another algorithm: held within 1e-6 instead
            check(d_pin <= 1e-6, f"NOT bitwise: infer with the globals True vs False "
                  f"max |diff| {d_pin:.3g} <= 1e-6")
        d_tf32 = max(float((unpinned[k] - off[k]).abs().max()) for k in keys)
        check(d_tf32 > max(d_pin, 1e-6), f"the pin bypassed (TF32) differs by more: max "
              f"|diff| {d_tf32:.3g}")
    finally:
        hook.remove()
        flags(False)


def op_trace(fn):
    """The ATen ops `fn` dispatches that compute floating outputs (no
    views, copies or lifted constants), in order, each with the float64
    sums of those outputs (a mismatch's diagnosis)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if not getattr(func, "is_view", False) and not any(
                    w in name for w in ("lift_fresh", "alias", "detach", "copy")):
                sums = [float(t.double().sum()) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor) and t.is_floating_point()]
                if sums:
                    self.ops.append((name, sums))
            return out

    with Log() as log_:
        fn()
    return log_.ops


def first_differing_op(fn_a, fn_b) -> str:
    """Where two runs that should compute the same thing part: the first
    non-view op whose name or output sums differ."""
    a, b = op_trace(fn_a), op_trace(fn_b)
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return f"op {i}: the sequences part, {x[0]} vs {y[0]}"
        if x[1] != y[1]:
            return f"op {i}: {x[0]} outputs differ (sums {x[1]} vs {y[1]})"
    return f"no op differs in the first {min(len(a), len(b))} ({len(a)} vs {len(b)} ops)"


def serving_phase(system, images, img, infer_w, bench_line, card):
    """Phase 5i: the serving path at full width on the card, on the main
    path's system (seeded weights, the default Config, its seeded
    generator) -> the K1 launches of the served calls and a JSON-able
    summary."""
    import os
    import shutil
    import tempfile

    from smirk_tpu_torch import kernels

    # the artifacts (~0.1 GB) go to a scratch directory of the checkout's
    # build directory (listed in .gitignore), removed at the end
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serving_", dir=kernels.BUILD_DIR)
    try:
        return _serving_phase(system, images, img, infer_w, bench_line, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _serving_phase(system, images, img, infer_w, bench_line, card, tmp):
    import io
    import os
    import threading
    import urllib.request

    import numpy as np
    import torch

    from smirk_tpu_torch import serving
    from smirk_tpu_torch.render import rasterizer as R

    B, S = img.shape[0], img.shape[1]
    log(f"[5i] serving: export_inference / load_inference at b{B}, InferenceServer, the "
        f"HTTP daemon, export_reconstruct, the sharded export {card}")
    res = {}
    t_phase = time.perf_counter()
    path = serving.export_inference(system, os.path.join(tmp, "inf"), batch_size=B)
    res["export_s"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    call = serving.load_inference(path)
    res["load_s"] = time.perf_counter() - t
    meta = call.meta
    nodes = [n for n in call.modules[0].graph.nodes
             if R.K1_OP.replace("::", ".") in str(n.target)]
    res["artifact_bytes"] = meta["bytes"]
    log(f"    export_inference: {res['export_s']:.2f} s, {meta['bytes'] / 1e6:.1f} MB, "
        f"platforms {meta['platforms']}, torch {meta['torch']}; load_inference "
        f"{res['load_s']:.2f} s")
    check(len(nodes) == 1, f"the exported graph calls {R.K1_OP} once ({len(nodes)})")
    want = system.infer(img)
    launches = 0
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        R.reset_launch_counts()
        got = call(images)
        torch.cuda.synchronize()
        launches += R.raster_fused_windows.launches
        check(R.raster_fused_windows.launches == 1,
              f"a served call (TF32 globals {tf32}) launched K1 once "
              f"({R.raster_fused_windows.launches})")
        differ = [k for k in serving.OUTPUT_KEYS if not torch.equal(got[k], want[k])]
        if differ:
            log(f"    NOT bitwise ({differ}); the first differing op: " + first_differing_op(
                lambda: call(img), lambda: system.infer(img)))
        check(not differ, f"served outputs == SmirkSystem.infer, bitwise, TF32 globals {tf32}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cov = float(got["rendered_mask"].mean())
    check(cov > 0.05 and int(got["raster_overflow"].max()) == 0,
          f"served coverage {cov:.4f} > 0.05, raster_overflow == 0")

    # the artifact on host images (what a server pays: the 38.5 MB copy in
    # included), and on the card's copy in windows that alternate with
    # infer's (the graph against the module's Python on the same input)
    art_w = timed_windows(lambda: call(images), 5, 10)
    dev_w, inf_w = [], []
    for _ in range(5):
        dev_w += timed_windows(lambda: call(img), 1, 10)
        inf_w += timed_windows(lambda: system.infer(img), 1, 10)
    dev_w, inf_w = sorted(dev_w), sorted(inf_w)
    res.update(artifact_ms=statistics.median(art_w), artifact_spread_pct=spread(art_w),
               artifact_on_card_ms=statistics.median(dev_w),
               artifact_on_card_spread_pct=spread(dev_w),
               infer_alternating_ms=statistics.median(inf_w),
               infer_alternating_spread_pct=spread(inf_w))
    log(f"    artifact call ms/batch{B} on host images median {res['artifact_ms']:.3f} over 5 "
        f"windows of 10 (min {art_w[0]:.3f}, max {art_w[-1]:.3f}, spread {spread(art_w):.1f} "
        f"%)  images/s {B / res['artifact_ms'] * 1e3:.1f}; on the card's copy "
        f"{res['artifact_on_card_ms']:.3f} (spread {spread(dev_w):.1f} %) against infer "
        f"{res['infer_alternating_ms']:.3f} (spread {spread(inf_w):.1f} %) in alternating "
        f"windows; [6]'s infer {statistics.median(infer_w):.3f} (spread {spread(infer_w):.1f} "
        f"%) {card}")

    log("    InferenceServer.predict on a ragged request of 100 images")
    server = serving.InferenceServer(path)
    rag = np.random.default_rng(9).random((100, S, S, 3), np.float32)
    R.reset_launch_counts()
    out = server.predict(rag)
    torch.cuda.synchronize()
    rag_launches = R.raster_fused_windows.launches
    launches += rag_launches
    head = system.infer(rag[:B])
    tail = system.infer(np.concatenate([rag[B:], np.zeros((2 * B - 100, S, S, 3),
                                                          np.float32)]))
    check(rag_launches == 2, f"the ragged request ran two chunks (K1 launched {rag_launches})")
    check(all(v.shape[0] == 100 for v in out.values())
          and all(np.array_equal(out[k][:B], head[k].cpu().numpy())
                  and np.array_equal(out[k][B:], tail[k][:100 - B].cpu().numpy())
                  for k in serving.OUTPUT_KEYS),
          "the outputs trimmed to 100, the first chunk == infer on its images, the tail "
          "== infer on the zero-padded chunk")

    log("    the HTTP daemon on a local port, one b64 /predict from a client thread")
    srv = serving.create_http_server(path, host="127.0.0.1", port=0)
    handler_s, predict_s = [], []
    do_post, predict = srv.RequestHandlerClass.do_POST, srv.inference.predict

    def timed_post(h):
        t = time.perf_counter()
        do_post(h)
        handler_s.append(time.perf_counter() - t)

    def timed_predict(*a, **k):
        t = time.perf_counter()
        r = predict(*a, **k)
        predict_s.append(time.perf_counter() - t)
        return r

    srv.RequestHandlerClass.do_POST, srv.inference.predict = timed_post, timed_predict
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rounds = []

    def client():
        for _ in range(4):  # one warm-up, three timed
            t0 = time.perf_counter()
            buf = io.BytesIO()
            np.savez(buf, img=images)
            body = buf.getvalue()
            t1 = time.perf_counter()
            reply = urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=body, method="POST")).read()
            t2 = time.perf_counter()
            npz = np.load(io.BytesIO(reply))
            got_h = {k: npz[k] for k in npz.files}
            t3 = time.perf_counter()
            rounds.append((t1 - t0, t2 - t1, t3 - t2, len(body), len(reply), got_h))

    try:
        th = threading.Thread(target=client)
        th.start()
        th.join(120)
    finally:
        srv.shutdown()
    check(len(rounds) == 4 and all(np.array_equal(rounds[-1][5][k], want[k].cpu().numpy())
                                   for k in serving.OUTPUT_KEYS),
          "the daemon's reply == SmirkSystem.infer")
    # the server's own npz work, timed alone on the same request and reply
    req_bytes = rounds[-1][3]
    buf = io.BytesIO()
    np.savez(buf, img=images)
    t = time.perf_counter()
    dec = np.load(io.BytesIO(buf.getvalue()))
    _ = dec["img"]
    s_dec = time.perf_counter() - t
    t = time.perf_counter()
    np.savez(io.BytesIO(), **rounds[-1][5])
    s_enc = time.perf_counter() - t
    med = {n: statistics.median(r[i] for r in rounds[1:]) * 1e3
           for i, n in enumerate(("client_encode", "request", "client_decode"))}
    hand = statistics.median(handler_s[1:]) * 1e3
    call_ms = statistics.median(predict_s[1:]) * 1e3
    rt = med["client_encode"] + med["request"] + med["client_decode"]
    # the server's npz work is timed alone above; the socket is the rest of
    # the request (both ends' reads and writes of the bodies)
    split = {"npz_encode": med["client_encode"] + s_enc * 1e3,
             "call": call_ms,
             "npz_decode": s_dec * 1e3 + med["client_decode"],
             "socket": med["request"] - call_ms - (s_enc + s_dec) * 1e3}
    res.update(http_roundtrip_ms=rt, http_images_s=B / rt * 1e3, http_split_ms=split,
               http_handler_ms=hand, http_request_mb=req_bytes / 1e6,
               http_reply_mb=rounds[-1][4] / 1e6)
    log(f"    HTTP round trip at b{B}: {rt:.3f} ms ({B / rt * 1e3:.1f} images/s; "
        f"{req_bytes / 1e6:.1f} MB in, {rounds[-1][4] / 1e6:.1f} MB out); split (ms, median "
        "of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" {card}")

    log(f"    export_reconstruct at b{B} (generator 32 features / 5 blocks)")
    t = time.perf_counter()
    rpath = serving.export_reconstruct(system, os.path.join(tmp, "rec"), batch_size=B)
    res["reconstruct_export_s"] = time.perf_counter() - t
    rserver = serving.InferenceServer(rpath)
    hull = torch.ones((B, S, S, 1), device=img.device)  # bench.py's box hull
    hull[:, S // 4: -S // 8, S // 4: -S // 4] = 0.0
    gen = torch.Generator(device=img.device).manual_seed(11)
    draws = system.reconstruct_draws(B, gen)
    order = serving.RECONSTRUCT_DRAWS
    R.reset_launch_counts()
    rout = rserver.call(images, hull, *(draws[k] for k in order))
    torch.cuda.synchronize()
    launches += R.raster_fused_windows.launches
    check(R.raster_fused_windows.launches == 1, "a served reconstruct call launched K1 once")
    masked, recon = system.reconstruct(want, img, hull, draws=draws)
    rdiff = [k for k, a, b in (("masked_img", rout["masked_img"], masked),
                               ("reconstructed_img", rout["reconstructed_img"], recon))
             if not torch.equal(a, b)]
    if rdiff:
        log(f"    NOT bitwise ({rdiff}); the first differing op: " + first_differing_op(
            lambda: rserver.call(img, hull, *(draws[k] for k in order)),
            lambda: system.reconstruct(system.infer(img), img, hull, draws=draws)))
    check(not rdiff, "the reconstruct artifact == SmirkSystem.reconstruct with the same "
          "draws, bitwise")
    hull_np = hull.cpu().numpy()
    p1 = rserver.predict(images, hull_np, seed=5)
    p2 = rserver.predict(images, hull_np, seed=5)
    check(all(np.array_equal(p1[k], p2[k]) for k in p1) and all(
        np.isfinite(v).all() for v in p1.values()), "served reconstruct deterministic per seed")
    # on the card's copy of the images, as the bench's one program takes them
    rec_w = timed_windows(lambda: rserver.call(img, hull, *(draws[k] for k in order)), 5, 3)
    res["reconstruct_artifact_ms"] = statistics.median(rec_w)
    res["reconstruct_artifact_spread_pct"] = spread(rec_w)
    log(f"    reconstruct artifact ms/batch{B} (images and draws on the card) median "
        f"{res['reconstruct_artifact_ms']:.3f} over 5 windows of 3 (spread {spread(rec_w):.1f} "
        f"%); [5g]'s reconstruct_fp32_ms_batch {bench_line['reconstruct_fp32_ms_batch']:.3f} "
        f"(its draws inside) {card}")

    log("    export_inference_sharded: 1 device against the plain artifact, 2 refused")
    spath = serving.export_inference_sharded(system, os.path.join(tmp, "sh1"), batch_size=B,
                                             n_devices=1)
    R.reset_launch_counts()
    sout = serving.load_inference(spath)(images)
    torch.cuda.synchronize()
    launches += R.raster_fused_windows.launches
    check(all(torch.equal(sout[k], want[k]) for k in serving.OUTPUT_KEYS),
          "the 1-device sharded artifact == the plain artifact, bitwise")
    spath2 = serving.export_inference_sharded(system, os.path.join(tmp, "sh2"), batch_size=B,
                                              n_devices=2)
    refused = ""
    try:
        serving.load_inference(spath2)
    except ValueError as e:
        refused = str(e)
    check(f"exported for 2 devices; host has {torch.cuda.device_count()}" in refused,
          f"a 2-device artifact is refused on this host: {refused!r}")
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"    [5i] took {res['phase_s']:.1f} s")
    return res


class _RenderWatch:
    """A system's renderer that records the dtypes of the vertices and the
    cams it is called with (a bf16 tensor must never reach the rasters)."""

    def __init__(self, renderer, seen):
        self.renderer, self.seen = renderer, seen

    def __call__(self, vertices, cam, *a, **kw):
        self.seen.add((vertices.dtype, cam.dtype))
        return self.renderer(vertices, cam, *a, **kw)

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def _counted(launches, fn):
    """fn() with every kernel count set to 0 just before it, its launches
    added to `launches` just after -> fn's result."""
    import torch

    from smirk_tpu_torch.render import rasterizer as R

    R.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for k in R.KERNELS:
        launches[k.__name__] = launches.get(k.__name__, 0) + k.launches
    return out


def _variant(**flags):
    """Config() with arch / train / loss-weight fields replaced."""
    import dataclasses

    from smirk_tpu_torch.config import Config

    c = Config()
    arch = {k: v for k, v in flags.items() if hasattr(c.arch, k)}
    weights = {k: v for k, v in flags.items() if hasattr(c.train.loss_weights, k)}
    train = {k: v for k, v in flags.items() if k not in arch and k not in weights}
    return dataclasses.replace(
        c, arch=dataclasses.replace(c.arch, **arch),
        train=dataclasses.replace(c.train, **train, loss_weights=dataclasses.replace(
            c.train.loss_weights, **weights)))


def _bf16_rule(got, want_bf16, want_fp32, base=None):
    """max |got - want_bf16| <= 2 max |want_bf16 - want_fp32| + 2 max |base
    - want_fp32| + 1e-7 -> (holds, err, bound)."""
    err = float((got.double() - want_bf16.double()).abs().max())
    bound = 2 * float((want_bf16.double() - want_fp32.double()).abs().max()) + 1e-7
    if base is not None:
        bound += 2 * float((base.double() - want_fp32.double()).abs().max())
    return err <= bound, err, bound


class _ConvWatch:
    """Within the block, the input dtypes of every convolution of the
    system's encoder and generator -> {'encoder.<name>' / 'generator.<name>':
    set of dtypes}."""

    def __init__(self, system):
        self.modules, self.seen, self.hooks = {"encoder": system.encoder,
                                               "generator": system.generator}, {}, []

    def __enter__(self):
        import torch

        for root, module in self.modules.items():
            for name, m in module.named_modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    self.hooks.append(m.register_forward_pre_hook(
                        lambda _, args, key=f"{root}.{name}": self.seen.setdefault(
                            key, set()).add(args[0].dtype)))
        return self.seen

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def _host_use(fn, n):
    """n back-to-back calls of fn, then a synchronize -> per call: wall ms,
    the calling thread's CPU ms and this process's CPU ms (all threads)."""
    import torch

    t, c, p = time.perf_counter(), time.thread_time(), time.process_time()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return {"wall_ms": (time.perf_counter() - t) / n * 1e3,
            "thread_cpu_ms": (time.thread_time() - c) / n * 1e3,
            "process_cpu_ms": (time.process_time() - p) / n * 1e3}


def _process_state() -> dict:
    """What else this process and its children hold: OS threads, Python
    threads, live child processes, objects the garbage collector tracks."""
    import gc
    import os
    import threading

    with open("/proc/self/status") as f:
        threads = int(next(ln for ln in f if ln.startswith("Threads:")).split()[1])
    me, children = str(os.getpid()), 0
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                children += f.read().rsplit(")", 1)[1].split()[1] == me
        except OSError:
            pass
    return {"os_threads": threads, "python_threads": threading.active_count(),
            "child_processes": children, "gc_objects": len(gc.get_objects())}


def precision_phase(bundle, img, bench_line, card):
    """Phase 5j: the precision options on the card. bf16_compute's training
    step at b32 on both parities (overflow and finiteness gates, K1 / K3 /
    K4's fold launched by these steps, the render's inputs fp32, the
    convolutions' inputs bf16 but for the generator's fp32 output head),
    then one window of 3 such steps with the host's CPU time beside the
    bench child's ([5g]); bf16_cycle_frozen's steps (the same gates, the
    encoder's convolutions in bf16 and fp32 at parity 0); remat_cycle's
    cycle loss, gradient and running statistics against the plain path's
    on one state; the fp32, cycle_frozen and remat steps' times and peak
    memory from a child process (`python -m smirk_tpu_torch.bench --inner
    train_options`: the bench's windows, as fresh as [5g]'s); the bf16
    reconstruct at b64 checked (its time is [5g]'s); the bf16 inference
    artifact bitwise equal to bf16 `infer`; the card against the CPU on 4
    images at the bf16 rule, the card's bf16 moved from its fp32 by at
    least half of what the CPU's moves, on the mean over outputs ->
    ({field: value}, launches)."""
    import os
    import shutil
    import tempfile

    import torch

    from smirk_tpu_torch import bench, kernels, serving
    from smirk_tpu_torch.device import fp32_math
    from smirk_tpu_torch.train.trainer import SmirkSystem

    B, S, TB = img.shape[0], img.shape[1], TRAIN_B
    log(f"[5j] precision: bf16_compute train_step at b{TB} (both parities), "
        f"bf16_cycle_frozen, remat_cycle, the training options' child (times, peak memory), "
        f"the bf16 reconstruct and artifact at b{B}, the card against the CPU {card}")
    res, launches = {}, {}
    tbatch = bench.train_batch(TB, S, 0)
    dev = img.device

    # the fp32, cycle_frozen and remat steps timed alike in a fresh process
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "smirk_tpu_torch.bench", "--inner",
                           "train_options"], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        log(proc.stderr[-2000:])
    check(proc.returncode == 0 and lines, f"the training options' child ran (rc "
          f"{proc.returncode})")
    opts = lines[-1]
    res["options_child_s"] = time.perf_counter() - t
    for name in ("fp32", "cycle_frozen", "remat"):
        for parity in (0, 1):
            for f in (f"train_ms_batch32_{name}_p{parity}", f"train_{name}_spread_pct_p{parity}",
                      f"train_host_ms_{name}_p{parity}", f"peak_mb_{name}_p{parity}"):
                check(isinstance(opts.get(f), float) and math.isfinite(opts[f]),
                      f"the options' child gave {f}")
                res[f] = opts[f]

    def checked_steps(system, name, gen):
        """One step of each parity with its gates -> {parity: the
        convolutions' input dtypes}."""
        seen, convs = set(), {}
        system.renderer = _RenderWatch(system.renderer, seen)
        try:
            for parity in (0, 1):
                with _ConvWatch(system) as convs[parity]:
                    m, _ = system.train_step(tbatch, parity, gen)
                check(all(math.isfinite(v) for v in m.values()) and m["raster_overflow"] == 0
                      and m["raster_overflow_2nd"] == 0,
                      f"{name} p{parity}: metrics finite, no raster overflow")
        finally:
            system.renderer = system.renderer.renderer
        check(seen == {(torch.float32, torch.float32)},
              f"{name}: the renderer saw fp32 vertices and cams only ({sorted(map(str, seen))})")
        return convs

    # bf16_compute: its own launch counts, so that the gate reads its steps
    sys_bf = SmirkSystem(_variant(bf16_compute=True), bundle)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16_launches = {}
    convs = _counted(bf16_launches, lambda: checked_steps(sys_bf, "bf16", gen))
    for parity in (0, 1):
        head = convs[parity].pop("generator.conv", None)
        check(head == {torch.float32} and convs[parity] and all(
            d == {torch.bfloat16} for d in convs[parity].values()),
            f"bf16 p{parity}: {len(convs[parity])} convolutions saw bf16 inputs, the "
            f"generator's output head fp32 ({head})")
    log(f"    this process before the window: {json.dumps(_process_state())}")
    for parity in (0, 1):
        use = _counted(bf16_launches, lambda: _host_use(
            lambda: sys_bf.train_step(tbatch, parity, gen), 3))
        res.update({f"inproc_bf16_{k}_p{parity}": v for k, v in use.items()})
    check(all(bf16_launches.get(k, 0) > 0 for k in (
        "raster_fused_windows", "raster_planes_windows", "segment_moments_to_faces")),
        f"the bf16 steps launched K1, K3 and K4's fold ({bf16_launches})")
    for k, v in bf16_launches.items():
        launches[k] = launches.get(k, 0) + v

    sys_cf = SmirkSystem(_variant(bf16_cycle_frozen=True), bundle)
    convs = _counted(launches, lambda: checked_steps(
        sys_cf, "cycle_frozen", torch.Generator(device=dev).manual_seed(0)))
    enc = {k: v for k, v in convs[0].items() if k.startswith("encoder.")}
    check(enc and all(d == {torch.float32, torch.bfloat16} for d in enc.values()),
          f"cycle_frozen p0: the encoder's {len(enc)} convolutions ran in fp32 (phase 1) and "
          f"bf16 (the frozen cycle)")
    del sys_cf
    torch.cuda.empty_cache()

    # remat against the plain cycle path: `_loss2` of each parity on one
    # state, with and without it -> the loss, the trained module's gradient
    # and the running statistics (moved once: twice would be ~10 % off)
    system = SmirkSystem(_variant(), bundle)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, aux = system.train_step(tbatch, 0, gen)
    state = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (system.encoder, system.generator)]
    batch_t = system._batch(tbatch)
    # cuDNN's deterministic algorithms for these runs, and the plain path
    # three times: what the backward's order of additions still moves (its
    # atomics) sets the gradient's floor, the larger of two plain reruns'
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    for parity in (0, 1):
        runs = {}
        for remat in (False, True, "again", "third"):
            system.config = _variant(remat_cycle=remat is True)
            system.encoder.load_state_dict(state[0])
            system.generator.load_state_dict(state[1])
            params = system.gen_params if parity == 0 else system.enc_params
            with fp32_math():
                loss, _ = _counted(launches, lambda: system._loss2(
                    batch_t, aux["encoder_output"], aux["transformed_vertices"], parity == 0,
                    parity == 1, torch.Generator(device=dev).manual_seed(1)))
                grads = system._grads(loss, params)
            stats = [v.clone() for m in (system.encoder, system.generator)
                     for k, v in m.state_dict().items() if "running" in k]
            runs[remat] = float(loss), grads, stats
        (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]

        def g_diff(ga, gb):
            return max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                       for a, b in zip(ga, gb))

        g_worst = g_diff(g0, g1)
        g_floor = max(g_diff(g0, runs[k][1]) for k in ("again", "third"))
        s_worst = max(float(((a - b).abs() / a.abs().clamp_min(1e-3)).max())
                      for a, b in zip(s0, s1))
        check(abs(l1 - l0) <= 1e-5 * abs(l0) and g_worst <= 2 * g_floor + 1e-5
              and s_worst <= 1e-4,
              f"remat_cycle p{parity}: the cycle loss ({l0:.7g} / {l1:.7g}), the gradient "
              f"(worst {g_worst:.3g} of max; plain reruns {g_floor:.3g}) and the running "
              f"statistics (worst {s_worst:.3g}; moved twice would be ~0.1) as without it")
    cudnn.deterministic, cudnn.benchmark = saved
    del system, state, aux
    torch.cuda.empty_cache()

    # the bf16 reconstruct, bench.py's one-program form at b64 ([5g] times it)
    hull = torch.ones((B, S, S, 1), device=dev)
    hull[:, S // 4: -S // 8, S // 4: -S // 4] = 0.0
    recon = _counted(launches, lambda: sys_bf.reconstruct(
        sys_bf.infer(img), img, hull, torch.Generator(device=dev).manual_seed(0))[1])
    check(bool(torch.isfinite(recon).all()), "the bf16 reconstruct is finite")

    # the bf16 artifact against bf16 infer, bitwise
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bf16_", dir=kernels.BUILD_DIR)
    try:
        t = time.perf_counter()
        path = serving.export_inference(sys_bf, os.path.join(tmp, "inf"), batch_size=B)
        res["bf16_export_s"] = time.perf_counter() - t
        call = serving.load_inference(path)
        want = _counted(launches, lambda: sys_bf.infer(img))
        got = _counted(launches, lambda: call(img))
        check(all(torch.equal(got[k], want[k]) for k in serving.OUTPUT_KEYS),
              f"the bf16 artifact equals bf16 infer bitwise ({len(serving.OUTPUT_KEYS)} outputs)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the card against the CPU on 4 images, one encoder in both precisions:
    # the bf16 rule per output, and the card's bf16 not its fp32
    keys = ("pose_params", "cam", "shape_params", "expression_params", "eyelid_params",
            "jaw_params", "vertices")
    sys_32 = SmirkSystem(_variant(), bundle, training=False)
    sys_32.encoder.load_state_dict(sys_bf.encoder.state_dict())
    cpu = {}
    for name, system in (("bf16", sys_bf), ("fp32", sys_32)):
        twin = SmirkSystem(system.config, bundle, device="cpu", training=False)
        twin.encoder.load_state_dict(system.encoder.state_dict())
        cpu[name] = twin.infer(img[:4].cpu())
    card_bf, card_32 = sys_bf.infer(img[:4]), sys_32.infer(img[:4])
    worst, moved = 0.0, {}
    for k in keys:
        ok, err, bnd = _bf16_rule(card_bf[k].cpu(), cpu["bf16"][k], cpu["fp32"][k],
                                  card_32[k].cpu())
        check(ok, f"card vs CPU bf16 {k}: max |diff| {err:.3g} <= {bnd:.3g}")
        worst = max(worst, err / bnd)
        ref = float((cpu["bf16"][k].double() - cpu["fp32"][k].double()).abs().max())
        if ref > 0:
            moved[k] = float((card_bf[k].double() - card_32[k].double()).abs().max()) / ref
    res["card_vs_cpu_bf16_worst_ratio"] = worst
    # a card that ran fp32 would move by 0; a few values an output make
    # one ratio noisy, so the gate reads their mean
    res["card_bf16_moved_mean"] = sum(moved.values()) / max(len(moved), 1)
    check(moved and res["card_bf16_moved_mean"] >= 0.5,
          f"the card's bf16 moved from its fp32 by {res['card_bf16_moved_mean']:.3g} of the "
          f"CPU's bf16-vs-fp32 difference on the mean over outputs (at least half; "
          + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()) + ")")
    del sys_bf, sys_32
    torch.cuda.empty_cache()

    line = {k: bench_line[k] for k in bench_line if k.startswith(("train_ms_batch32_",
                                                                   "train_host_ms_"))}
    log(f"    [5g]'s child: fp32 p0 / p1 {line['train_ms_batch32_fp32_p0']:.3f} / "
        f"{line['train_ms_batch32_fp32_p1']:.3f} ms (the host's thread "
        f"{line['train_host_ms_fp32_p0']:.3f} / {line['train_host_ms_fp32_p1']:.3f}), bf16 "
        f"{line['train_ms_batch32_bf16_p0']:.3f} / {line['train_ms_batch32_bf16_p1']:.3f} "
        f"({line['train_host_ms_bf16_p0']:.3f} / {line['train_host_ms_bf16_p1']:.3f}); bf16 "
        f"reconstruct {bench_line['reconstruct_bf16_ms_batch']:.3f} ms {card}")
    log("    the options' child: " + "; ".join(
        f"{name} {res[f'train_ms_batch32_{name}_p0']:.3f} / "
        f"{res[f'train_ms_batch32_{name}_p1']:.3f} ms (host "
        f"{res[f'train_host_ms_{name}_p0']:.3f} / {res[f'train_host_ms_{name}_p1']:.3f}, "
        f"peak {res[f'peak_mb_{name}_p0']:.1f} / {res[f'peak_mb_{name}_p1']:.1f} MiB)"
        for name in ("fp32", "cycle_frozen", "remat")) + f" {card}")
    log("    bf16 in this process (3 steps): " + "; ".join(
        f"p{p} " + ", ".join(f"{k} {res[f'inproc_bf16_{k}_p{p}']:.3f}" for k in (
            "wall_ms", "thread_cpu_ms", "process_cpu_ms"))
        for p in (0, 1)) + f" {card}")
    return res, launches


def _he_state_dict(module, generator):
    """A seeded state dict for a teacher in its reference layout: kernels
    N(0, 2 / fan in), batch norm near identity, running variances in
    [0.8, 1.3]."""
    import torch

    out = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            out[k] = v
        elif v.ndim >= 2:
            out[k] = torch.randn(v.shape, generator=generator) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=generator) * 0.5 + 0.8
        elif k.endswith("weight") and "prelu" not in k:
            out[k] = 1.0 + torch.randn(v.shape, generator=generator) * 0.05
        else:
            out[k] = torch.randn(v.shape, generator=generator) * 0.05
    return out


def teachers_phase(bundle, train_ms, card):
    """Phase 5k: the three teachers at full depth, from seeded files in the
    reference checkpoints' layouts written to a scratch directory, through
    the loaders, in a b32 training step at the recipes' weights
    (perceptual_vgg_loss 10, emotion_loss 1, mica_loss 10): every teacher
    loss finite and nonzero, the step's time and its split into the
    teachers' forwards and backwards, and the card against the CPU on a b2
    `_loss1` -> ({field: value}, launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from smirk_tpu_torch import bench, kernels
    from smirk_tpu_torch.masking import masking as masking_lib
    from smirk_tpu_torch.models import teachers
    from smirk_tpu_torch.models.emoca_resnet import EmocaResNet50, emotion_embedding_distance
    from smirk_tpu_torch.models.mica import Mica
    from smirk_tpu_torch.models.vgg import VGG16_BLOCK_CONVS, perceptual_loss
    from smirk_tpu_torch.train.trainer import SmirkSystem

    cfg = _variant(perceptual_vgg_loss=10.0, emotion_loss=1.0, mica_loss=10.0)
    TB, S = TRAIN_B, cfg.image_size
    log(f"[5k] teachers: VGG16, EMOCA ResNet50 and MICA at full depth from seeded reference "
        f"files, a b{TB} train_step at the recipes' weights, the split, the card against the "
        f"CPU {card}")
    res, launches = {}, {}
    gen = torch.Generator().manual_seed(0)
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="teachers_", dir=kernels.BUILD_DIR)
    try:
        t = time.perf_counter()
        # torchvision's vgg16 `features` (all 13 convolutions, the loss reads
        # the first 10), EMOCA's {'state_dict': {'backbone.*'}}, mica.tar
        vgg_sd, in_ch = {}, 3
        for idx, ch in [c for block in VGG16_BLOCK_CONVS for c in block] + [
                (24, 512), (26, 512), (28, 512)]:
            vgg_sd[f"features.{idx}.weight"] = torch.randn(
                (ch, in_ch, 3, 3), generator=gen) * (2.0 / (in_ch * 9)) ** 0.5
            vgg_sd[f"features.{idx}.bias"] = torch.randn((ch,), generator=gen) * 0.05
            in_ch = ch
        emo = {f"backbone.{k}": v for k, v in _he_state_dict(EmocaResNet50(), gen).items()}
        mica = _he_state_dict(Mica(), gen)
        files = {"vgg16.pth": vgg_sd, "emotion.ckpt": {"state_dict": emo},
                 "mica.tar": {"arcface": {k[8:]: v for k, v in mica.items()
                                          if k.startswith("arcface.")},
                              "flameModel": {k: v for k, v in mica.items()
                                             if k.startswith("regressor.")}}}
        paths = {}
        for name, obj in files.items():
            paths[name] = os.path.join(tmp, name)
            torch.save(obj, paths[name])
        res["teacher_files_mb"] = sum(os.path.getsize(p) for p in paths.values()) / 1e6
        res["teacher_files_s"] = time.perf_counter() - t

        def load(device):
            return dict(vgg_variables=teachers.load_vgg_teacher(paths["vgg16.pth"], device),
                        emotion_variables=teachers.load_emotion_teacher(
                            paths["emotion.ckpt"], device),
                        mica_variables=teachers.load_mica_teacher(paths["mica.tar"], device))

        t = time.perf_counter()
        loaded = load(None)  # the card
        res["teacher_load_s"] = time.perf_counter() - t
        system = SmirkSystem(cfg, bundle, **loaded)
        check(all(m is not None and not m.training for m in (system.vgg, system.emotion,
                                                              system.mica)),
              "the loaders gave the three teachers in eval mode")
        tbatch = bench.train_batch(TB, S, 0)
        tbatch["img_mica"] = np.random.default_rng(1).random((TB, 112, 112, 3), np.float32)
        gen_t = torch.Generator(device=system.device).manual_seed(0)
        for parity in (0, 1):
            m, _ = _counted(launches, lambda: system.train_step(tbatch, parity, gen_t))
            check(all(math.isfinite(v) for v in m.values()) and m["raster_overflow"] == 0,
                  f"teachers p{parity}: metrics finite, no raster overflow")
            check(all(m[k] > 0 for k in ("perceptual_vgg_loss", "emotion_loss", "mica_loss")),
                  f"teachers p{parity}: perceptual {m['perceptual_vgg_loss']:.5g}, emotion "
                  f"{m['emotion_loss']:.5g}, mica {m['mica_loss']:.5g}, each > 0")
            ms = _counted(launches, lambda: timed_windows(
                lambda: system.train_step(tbatch, parity, gen_t), 2, 3))
            res[f"train_ms_batch{TB}_teachers_p{parity}"] = statistics.median(ms)
            res[f"train_teachers_spread_pct_p{parity}"] = spread(ms)
        check(all(launches.get(k, 0) > 0 for k in (
            "raster_fused_windows", "raster_planes_windows", "segment_moments_to_faces")),
            f"the teachers' steps launched K1, K3 and K4's fold ({launches})")

        # the split: each teacher's share of a step at b32, CUDA events
        dev = system.device
        rng = np.random.default_rng(2)
        x = torch.as_tensor(rng.random((TB, S, S, 3), np.float32), device=dev)
        y = torch.as_tensor(rng.random((TB, S, S, 3), np.float32), device=dev)
        xm = torch.as_tensor(tbatch["img_mica"], device=dev)

        def vgg_fwd():
            with torch.no_grad():
                perceptual_loss(system.vgg, x, y)

        def vgg_fwd_bwd():
            xg = x.detach().requires_grad_(True)
            torch.autograd.grad(perceptual_loss(system.vgg, xg, y), xg)

        def emotion_fwd_bwd():
            xg = x.detach().requires_grad_(True)
            torch.autograd.grad(emotion_embedding_distance(system.emotion, xg, y).mean(), xg)

        def gen_reforward():
            gin = torch.cat([x, y], -1)
            with torch.no_grad():
                system.generator.eval()
                system.generator(gin)

        def mica_fwd():
            with torch.no_grad():
                system.mica(xm)

        for name, fn in (("vgg_forward", vgg_fwd), ("vgg_forward_backward", vgg_fwd_bwd),
                         ("emotion_forward_backward", emotion_fwd_bwd),
                         ("emotion_generator_reforward", gen_reforward),
                         ("mica_forward", mica_fwd)):
            res[f"split_{name}_ms"] = cuda_ms(fn, 5, 1)

        # the card against the CPU: `_loss1` at b2 on the same draws
        twin = SmirkSystem(cfg, bundle, device="cpu", **load("cpu"))
        twin.encoder.load_state_dict(system.encoder.state_dict())
        twin.generator.load_state_dict(system.generator.state_dict())
        small = {k: v[:2] for k, v in tbatch.items()}
        draws = masking_lib.reconstruct_draws(2, system.num_mask_points, S,
                                              torch.Generator().manual_seed(3), "cpu")
        draws = {k: draws[k] for k in ("u", "bary", "noise", "drop_centers")}
        _, aux_c = _counted(launches, lambda: system._loss1(
            system._batch(small), True, draws={k: v.to(dev) for k, v in draws.items()}))
        _, aux_h = twin._loss1(twin._batch(small), True, draws=draws)
        for k in ("perceptual_vgg_loss", "emotion_loss", "mica_loss", "reconstruction_loss"):
            a, b = float(aux_c["losses"][k]), float(aux_h["losses"][k])
            check(abs(a - b) <= 1e-3 * abs(b), f"card vs CPU _loss1 {k}: {a:.6g} vs {b:.6g} "
                  f"(1e-3 relative)")
        del system, twin
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    split = sum(v for k, v in res.items() if k.startswith("split_") and k != "split_vgg_forward_ms")
    log(f"    teachers' step p0 / p1 {res[f'train_ms_batch{TB}_teachers_p0']:.3f} / "
        f"{res[f'train_ms_batch{TB}_teachers_p1']:.3f} ms against [6]'s "
        f"{train_ms[0]:.3f} / {train_ms[1]:.3f} without them; split (ms, CUDA events): "
        + ", ".join(f"{k[6:-3]} {v:.3f}" for k, v in res.items() if k.startswith("split_"))
        + f" (sum without the forward-only VGG {split:.3f}) {card}")
    return res, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at batch 8, then stop")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from smirk_tpu_torch import Predictor, bench, kernels
        from smirk_tpu_torch.assets import procedural_bundle
        from smirk_tpu_torch.render import rasterizer as R
    except ImportError as e:
        print(f"chip_smoke: the smirk_tpu_torch package is not here ({e})",
              file=sys.stderr)
        return 2

    TRAIN_KERNELS = (R.raster_fused_windows, R.raster_planes_windows,
                     R.segment_moments_to_faces)

    # ---------------- 1. device ----------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"[1] device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log("nvidia-smi name,power.limit:")
    log(smi)
    card = f"[{smi}]"

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    report = kernels.build(force=True)
    log(f"[2] built {sorted(report)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for lib, rep in sorted(report.items()):
        for line in rep["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {lib}: {line.strip()}")

    # ---------------- main-path inputs ----------------
    B = 8 if args.quick else INFER_B
    S = 224
    bundle = procedural_bundle(seed=0, full_size=True)
    # bench.py's cam_fix: random-init weights leave cam = [7, 0, 0], so
    # the face region is recentred onto the optical axis (here in the
    # template, the same translation before the cam scale)
    vt = np.array(bundle["v_template"], np.float32)
    centre = vt[np.asarray(bundle["face_vertex_ids"])].mean(0)
    vt[:, :2] -= centre[:2]
    bundle["v_template"] = vt
    pred = Predictor(bundle=bundle)  # device None = the card
    system = pred.system
    renderer = system.renderer
    log(f"    bundle V={vt.shape[0]} F={bundle['faces'].shape[0]}; render F="
        f"{renderer.faces.shape[0]} capacity {renderer.bin_capacity} budget "
        f"{renderer.raster_compact}")
    images = np.random.default_rng(0).random((B, S, S, 3), np.float32)
    img = pred._prepare(images, None)

    with torch.inference_mode():
        enc = system.encoder(img)
        fl = system.flame(enc)
        tv = renderer.project(fl["vertices"], enc["cam"])
        face_verts, face_normals = renderer._face_geometry(fl["vertices"], tv)
        cap = renderer.bin_capacity
        CPT = cap // R.V3_CHUNK
        TX = -(-S // R.TILE_COLS)
        bins, counts = R.bin_faces_flat(face_verts, S, cap)
        Tp = bins.shape[1]
        records = R.fused_records(face_verts, face_normals)
        budget = -(-renderer.raster_compact // 8) * 8
        kept, dropped = R._windows(counts, budget)
        kept_p, _ = R._windows(counts, None)
        # K3 at the training shapes: the first TRAIN_B images
        BT = min(B, TRAIN_B)
        D = 3
        fvt, fnt = face_verts[:BT], face_normals[:BT]
        bins_t, counts_t = R.bin_faces_flat(fvt, S, cap)
        prec = R.planes_records(fvt, fnt)
        boxes_t = R.cull_boxes(fvt, S)  # as K3 computes them in its staging
        raw_t = torch.stack(R._bbox_and_priority(fvt, S)[:4], -1)
        FIVE = ("p2f", "zbuf", "nx", "ny", "nz")
        K3_OUT = ("p2f", "zbuf", "slot", "vals")

        # ---------------- 3. K2's contract through the read-through path ----------------
        log(f"[3] K2's contract: K1 at B={B} and K3 at B={BT} reading the bins through, "
            f"against the packed route (plan + compact_faces_plain + gather), budgets "
            f"{budget} and 8")
        k2_err = 0.0
        for bud in (budget, 8):
            kb, ob = R._windows(counts, bud)
            s_, e_, recs_, ovf_ = R.packed_layout_plain(records, bins, counts, bud)
            check(torch.equal(ob, ovf_), f"overflow at budget {bud} == the plan's "
                  f"(max {int(ob.max())})")
            got = R.raster_fused_windows(kb, bins, records, face_verts, S, TX)
            want = R._fused_plain(s_, e_, recs_, S, TX)
            kb3, ob3 = R._windows(counts_t, bud)
            s3_, e3_, recs3_, ovf3_ = R.packed_layout_plain(prec, bins_t, counts_t, bud)
            check(torch.equal(ob3, ovf3_), f"K3 inputs: overflow at budget {bud} == the plan's")
            got3 = R.raster_planes_windows(kb3, bins_t, prec, fvt, S, TX, D)
            want3 = R._planes_plain(s3_, e3_, recs3_, S, TX, D)
            torch.cuda.synchronize()
            for nm, a, b in (*zip(FIVE, got, want), *zip(K3_OUT, got3, want3)):
                check(torch.equal(a, b), f"budget {bud}: read-through {nm} == the packed "
                      "route's (bitwise)")
                k2_err = max(k2_err, float((a.double() - b.double()).abs().max()))
        check(int(ob.min()) > 0 and int(ob3.min()) > 0, "budget 8 drops chunks in every image")

        # ---------------- 4. K1 / K1b ----------------
        log("[4] K1 raster_fused_windows (bins read through, warp cull), compact and "
            "padded layouts")
        k1 = R.raster_fused_windows(kept, bins, records, face_verts, S, TX)
        k1_plain = R.raster_fused_windows_plain(kept, bins, records, S, TX)
        torch.cuda.synchronize()
        k1_err = 0.0
        for nm, a, b in zip(FIVE, k1, k1_plain):
            check(torch.equal(a, b), f"culled K1 {nm} == plain, every face tested (bitwise)")
            k1_err = max(k1_err, float((a.double() - b.double()).abs().max()))
        k1b = R.raster_fused_windows(kept_p, bins, records, face_verts, S, TX)
        k1b_plain = R.raster_fused_windows_plain(kept_p, bins, records, S, TX)
        torch.cuda.synchronize()
        k1b_err = 0.0
        for nm, a, b in zip(FIVE, k1b, k1b_plain):
            check(torch.equal(a, b), f"K1b (padded) {nm} == plain (bitwise)")
            k1b_err = max(k1b_err, float((a.double() - b.double()).abs().max()))
        check(int(dropped.max()) == 0, f"no overflow at the budget {budget}")
        check(torch.equal(kept, kept_p), "compact and padded layouts keep the same chunks")
        for nm, a, b in zip(FIVE, k1, k1b):
            check(torch.equal(a, b), f"compact {nm} == padded {nm}")
        # truncated budget: overflow from the plan, trailing tiles empty
        tb = 24
        tkept, tdrop = R._windows(counts, tb)
        tk1 = R.raster_fused_windows(tkept, bins, records, face_verts, S, TX)
        tk1_plain = R.raster_fused_windows_plain(tkept, bins, records, S, TX)
        for nm, a, b in zip(FIVE, tk1, tk1_plain):
            check(torch.equal(a, b), f"K1 {nm} == plain at budget {tb}")
        occupied = ((counts + 31) // 32).sum(1)
        check(torch.equal(tdrop, (occupied - tb).clamp_min(0).to(torch.int32))
              and int(tdrop.min()) > 0, f"overflow at budget {tb} = occupied - {tb} "
              f"(min {int(tdrop.min())}, max {int(tdrop.max())})")
        _, _, _, ovf = R.rasterize_normals_fused(
            face_verts, face_normals, S, capacity=cap, compact=tb,
            return_overflow=True)
        check(torch.equal(ovf, tdrop), "rasterize_normals_fused overflow == plan's")
        empty = tkept == 0  # tiles clipped past the budget
        check(bool((tk1[0][empty] == -1).all()) and bool(empty.any()),
              f"{int(empty.sum())} clipped tiles render empty")
        intact = tkept == kept
        check(torch.equal(tk1[0][intact], k1[0][intact]),
              "tiles inside the truncated budget equal the full render")

    # ---------------- 4b. K3 / K3b at the training shapes ----------------
    dev = face_verts.device
    F_render = int(renderer.faces.shape[0])
    log(f"[4b] K3 raster_planes_windows (bins read through, warp cull) at B={BT}, "
        "compact and padded layouts")
    with torch.inference_mode():
        kept3, drop3 = R._windows(counts_t, budget)
        kept3p, _ = R._windows(counts_t, None)
        k3 = R.raster_planes_windows(kept3, bins_t, prec, fvt, S, TX, D)
        k3_plain = R.raster_planes_windows_plain(kept3, bins_t, prec, S, TX, D)
        torch.cuda.synchronize()
        k3_err = 0.0
        for nm, a, b in zip(K3_OUT, k3, k3_plain):
            check(torch.equal(a, b), f"culled K3 {nm} == plain, every face tested (bitwise)")
            k3_err = max(k3_err, float((a.double() - b.double()).abs().max()))
        k3b = R.raster_planes_windows(kept3p, bins_t, prec, fvt, S, TX, D)
        k3b_plain = R.raster_planes_windows_plain(kept3p, bins_t, prec, S, TX, D)
        torch.cuda.synchronize()
        k3b_err = 0.0
        for nm, a, b in zip(K3_OUT, k3b, k3b_plain):
            check(torch.equal(a, b), f"culled K3b (padded) {nm} == plain (bitwise)")
            k3b_err = max(k3b_err, float((a.double() - b.double()).abs().max()))
        check(int(drop3.max()) == 0, f"no overflow at the budget {budget}")
        for nm, a, b in zip(K3_OUT, k3, k3b):
            check(torch.equal(a, b), f"K3 compact {nm} == padded {nm}")
        check(bool((k3[2] < cap).all()) and int(k3[2].max()) >= 0,
              "slots are per-tile indices into the bins")
        unbounded = int(torch.isinf(boxes_t[..., 0]).sum())
        log(f"    cull boxes: {unbounded} of {boxes_t.shape[0] * boxes_t.shape[1]} faces too "
            "thin to cull (unbounded)")
        tkept3, tdrop3 = R._windows(counts_t, tb)
        tk3 = R.raster_planes_windows(tkept3, bins_t, prec, fvt, S, TX, D)
        tk3_plain = R.raster_planes_windows_plain(tkept3, bins_t, prec, S, TX, D)
        for nm, a, b in zip(K3_OUT, tk3, tk3_plain):
            check(torch.equal(a, b), f"K3 {nm} == plain at budget {tb}")
        _, _, _, ovf3 = R.rasterize_planes_diff(fvt, fnt, S, cap, tb)
        check(torch.equal(ovf3, tdrop3) and int(tdrop3.min()) > 0,
              f"rasterize_planes_diff overflow at budget {tb} == the plan's "
              f"(min {int(tdrop3.min())}, max {int(tdrop3.max())})")
        empty3 = tkept3 == 0
        check(bool(empty3.any()) and bool((tk3[0][empty3] == -1).all())
              and bool((tk3[2][empty3] == -1).all()),
              f"{int(empty3.sum())} clipped tiles render empty with slot -1")

        # ---------------- 4c. K4 / K5 ----------------
        log(f"[4c] K4 segment_moments_to_faces (fold) and segment_moments (store), K5 "
            f"fold_slots_to_faces vs plain at B={BT}, C={cap}, D={D}, F={F_render}")
        gimg = torch.randn((BT, S, S, D), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
        g_t = R.image_to_tiles(gimg, S).contiguous()
        slots3 = k3[2]
        k4_scale = R.segment_sum(slots3, R.moment_rows(g_t, S).abs(), cap)
        k4f = R.segment_moments_to_faces(slots3, g_t, bins_t, cap, S, F_render)
        k4f_plain = R.segment_moments_to_faces_plain(slots3, g_t, bins_t, cap, S, F_render)
        torch.cuda.synchronize()
        k4f_ratio, k4f_err = within(
            k4f, k4f_plain, R.fold_slots_to_faces_plain(k4_scale, bins_t, F_render),
            "K4 fold vs plain composition")
        check(float(k4f.abs().sum()) > 0, "K4's fold folded a nonzero gradient")
        k4 = R.segment_moments(slots3, g_t, cap, S)
        k4_plain = R.segment_moments_plain(slots3, g_t, cap, S)
        torch.cuda.synchronize()
        k4_ratio = within(k4, k4_plain, k4_scale, "K4 store vs plain")[0]
        k5 = R.fold_slots_to_faces(k4, bins_t, F_render)
        k5_plain = R.fold_slots_to_faces_plain(k4, bins_t, F_render)
        k5_scale = R.fold_slots_to_faces_plain(k4.abs(), bins_t, F_render)
        torch.cuda.synchronize()
        k5_ratio = within(k5, k5_plain, k5_scale,
                          f"K5 vs plain at the training shapes, C={cap}, CHN={3 * D}")[0]
        check(float(k5.abs().sum()) > 0, "K5 folded a nonzero gradient")

    # ---------------- 4d. the raster gradient ----------------
    G4 = min(4, B)
    log(f"[4d] rasterize gradient at b{G4}: card vs a dense reference and vs the CPU path")
    fv4 = face_verts[:G4].clone().requires_grad_(True)
    fn4 = face_normals[:G4].clone().requires_grad_(True)
    R.reset_launch_counts()
    vals4, _, p2f4, _ = R.rasterize(fv4, fn4, S, cap, compact=budget)
    w4 = torch.randn(vals4.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    d_fv, d_fn = torch.autograd.grad((vals4 * w4).sum(), (fv4, fn4))
    torch.cuda.synchronize()
    check(R.raster_planes_windows.launches == 1 and R.segment_moments_to_faces.launches == 1
          and R.segment_moments.launches == 0 and R.fold_slots_to_faces.launches == 0,
          "one forward + backward launched K3 and K4's fold once each, and neither K4's "
          "store nor K5")
    ref_fv, sc_fv, ref_fn, sc_fn = R.dense_gradient_and_scale(
        p2f4, fv4.detach(), fn4.detach(), w4)
    grad_ratio = max(within(d_fv, ref_fv, sc_fv, "d face_verts vs dense", GRAD_RTOL)[0],
                     within(d_fn, ref_fn, sc_fn, "d normals vs dense", GRAD_RTOL)[0])
    dvals, _ = R.interpolate_attributes(p2f4, fv4.detach(), fn4.detach())
    log(f"    values vs dense: max |diff| {float((vals4.detach() - dvals).abs().max()):.3g}")
    fvc = fv4.detach().cpu().requires_grad_(True)
    fnc = fn4.detach().cpu().requires_grad_(True)
    vc, _, pc, _ = R.rasterize(fvc, fnc, S, cap, compact=budget)
    dc_fv, dc_fn = torch.autograd.grad((vc * w4.cpu()).sum(), (fvc, fnc))
    check(torch.equal(pc, p2f4.cpu()), "pix_to_face card == cpu")
    within(d_fv.cpu(), dc_fv, sc_fv.cpu(), "d face_verts card vs cpu", GRAD_RTOL)
    within(d_fn.cpu(), dc_fn, sc_fn.cpu(), "d normals card vs cpu", GRAD_RTOL)

    # ---------------- 4e. K6 ----------------
    log(f"[4e] K6 raster_coverage_windows (bins read through, warp cull) at B={BT}, "
        f"capacity 512 and {cap}")
    with torch.inference_mode():
        crec = R.coverage_records(fvt)
        k6, k6_err = {}, 0.0
        for c6 in (512, cap):
            b6, n6 = R.bin_faces_flat(fvt, S, c6)
            kept6 = R._windows(n6, None)[0]
            out6 = R.raster_coverage_windows(kept6, b6, crec, fvt, S, TX)
            plain6 = R.raster_coverage_windows_plain(kept6, b6, crec, S, TX)
            torch.cuda.synchronize()
            for nm, a, b in zip(("p2f", "zbuf", "slot"), out6, plain6):
                check(torch.equal(a, b), f"culled K6 {nm} == plain, every face tested, at "
                      f"capacity {c6} (bitwise)")
                k6_err = max(k6_err, float((a.double() - b.double()).abs().max()))
            k3c = R.raster_planes_windows(kept6, b6, prec, fvt, S, TX, D)
            for nm, a, b in zip(("p2f", "zbuf", "slot"), out6, k3c):
                check(torch.equal(a, b), f"K6 {nm} == K3's on the same bins at capacity {c6}")
            k6[c6] = (b6, kept6, out6)
        check(float((k6[512][2][0] >= 0).float().mean()) > 0.05, "K6 covers > 5 % of pixels")

        # ---------------- 4f. K7 ----------------
        log("[4f] K7 segment_reduce_tiles vs segment_sum (one scatter_add_), NaN in "
            "the dropped rows")
        k7_limit = kernels.library("segment_reduce").smirk_max_shared_optin(dev.index)

        def nan_dropped(slots, payload, c):
            """The payload with NaN in every row whose slot is outside [0, c)."""
            drop = (slots < 0) | (slots >= c)
            return torch.where(drop[..., None], float("nan"), payload)

        slots7 = R.image_to_tiles(R._tiles_to_image(k6[512][2][2], S), S).contiguous()
        gen7 = torch.Generator(device=dev).manual_seed(7)
        pay7 = nan_dropped(slots7, torch.randn(tuple(slots7.shape) + (36,), device=dev,
                                               generator=gen7), 512)
        k7 = R.segment_reduce_tiles(slots7, pay7, 512)
        k7_plain = R.segment_sum(slots7, pay7, 512)
        torch.cuda.synchronize()
        group7, span7 = R._reduce_blocks(512, 36, k7_limit)
        check((group7, span7) == (36, 176), f"K7 at C=512, CHN=36: runs of {span7} "
              f"slots x {group7} channels, {span7 * group7 * 4} bytes of accumulators "
              "a block")
        check(bool(torch.isfinite(k7).all()), "K7 finite with NaN in the dropped rows")
        k7_ratio, k7_err = within(k7, k7_plain, R.segment_sum(slots7, pay7.abs(), 512),
                                  "K7 vs plain, C=512, CHN=36")
        k7_rows = int(((slots7 >= 0) & (slots7 < 512)).sum())
        covered7 = int((R._tiles_to_image(slots7, S) >= 0).sum())
        log(f"    K7 reads {k7_rows} of {slots7.numel()} payload rows "
            f"({k7_rows / slots7.numel() * 100:.1f} %: {covered7} covered pixels, "
            f"{k7_rows - covered7} padding pixels with slot 0)")
        B7 = min(B, 8)
        slots7b = torch.randint(-1, 1024 + 128, (B7, Tp, R.TILE_PIX), device=dev,
                                generator=gen7, dtype=torch.int32)
        pay7b = nan_dropped(slots7b, torch.randn((B7, Tp, R.TILE_PIX, 72), device=dev,
                                                 generator=gen7), 1024)
        group7b, span7b = R._reduce_blocks(1024, 72, k7_limit)
        k7b = R.segment_reduce_tiles(slots7b, pay7b, 1024)
        check(span7b < 1024, f"K7 at C=1024, CHN=72 (295 KB) splits the slots into "
              f"runs of {span7b} ({span7b * group7b * 4} bytes a block)")
        check(bool(torch.isfinite(k7b).all()), "K7 finite with NaN in the dropped rows, "
              "C=1024, CHN=72")
        within(k7b, R.segment_sum(slots7b, pay7b, 1024),
               R.segment_sum(slots7b, pay7b.abs(), 1024), "K7 vs plain, C=1024, CHN=72")
        # K5 where the op path runs it: on K7's rows, NaN in every row of a
        # slot that holds no face (its contract drops them; K5 never reads them)
        b5op = k6[512][0]
        pay5 = torch.where((b5op < 0)[..., None], float("nan"), k7).contiguous()
        k5op = R.fold_slots_to_faces(pay5, b5op, F_render)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k5op).all()), "K5 finite with NaN in the rows of slots "
              "without a face, C=512, CHN=36")
        k5op_ratio, k5op_err = within(
            k5op, R.fold_slots_to_faces_plain(pay5, b5op, F_render),
            R.fold_slots_to_faces_plain(pay5.abs(), b5op, F_render),
            "K5 vs plain at the op path's shapes, C=512, CHN=36")
        k5_rows = int((b5op >= 0).sum())
        log(f"    K5 reads {k5_rows} of {b5op.numel()} slot rows "
            f"({k5_rows / b5op.numel() * 100:.1f} %: the slots that hold a face)")

        # ---------------- 4g. K8 ----------------
        log(f"[4g] K8 raster_bins_coverage (staged ahead, warp cull) at B={BT}, "
            f"capacity {cap}")
        fv9 = fvt.reshape(BT, -1, 9).contiguous()
        k8 = R.raster_bins_coverage(counts_t, bins_t, fv9, S)
        k8_plain = R.raster_bins_coverage_plain(counts_t, bins_t, fv9, S)
        torch.cuda.synchronize()
        k8_err = 0.0
        for nm, a, b in zip(("p2f", "zbuf"), k8, k8_plain):
            check(torch.equal(a, b), f"culled K8 {nm} == plain, every face tested (bitwise)")
            k8_err = max(k8_err, float((a.double() - b.double()).abs().max()))
        k6_img = [R._tiles_to_image(x, S) for x in k6[cap][2][:2]]
        k8_bad = tie_mismatches(k8[0][:, :S, :S], k6_img[0], k8[1][:, :S, :S], k6_img[1],
                                fvt, S)
        log(f"    K8 vs K6 pix_to_face: {k8_bad} tie pixels")

        # ---------------- 4h. K4 past 48 KB ----------------
        log("[4h] K4 at D=6, capacity 768 (55 KB of accumulators), both epilogues")
        slots4 = torch.randint(-1, 768, (B7, Tp, R.TILE_PIX), device=dev, generator=gen7,
                               dtype=torch.int32)
        g4 = torch.randn((B7, Tp, R.TILE_PIX, 6), device=dev, generator=gen7)
        bins4 = torch.randint(-1, F_render, (B7, Tp, 768), device=dev, generator=gen7,
                              dtype=torch.int32)
        scale4 = R.segment_sum(slots4, R.moment_rows(g4, S).abs(), 768)
        within(R.segment_moments(slots4, g4, 768, S), R.segment_moments_plain(slots4, g4, 768, S),
               scale4, "K4 store vs plain at C=768, D=6")
        within(R.segment_moments_to_faces(slots4, g4, bins4, 768, S, F_render),
               R.segment_moments_to_faces_plain(slots4, g4, bins4, 768, S, F_render),
               R.fold_slots_to_faces_plain(scale4, bins4, F_render),
               "K4 fold vs plain composition at C=768, D=6")

    # ---------------- 4i. K9 / K10 / K11 ----------------
    log(f"[4i] K9 raster_fused_groups, K10 raster_fused_groups_local, K11 "
        f"raster_chunkskip at B={B}, capacity {cap}")
    k1_img = [R._tiles_to_image(x, S) for x in k1[:2]]  # the compact K1 render
    with torch.inference_mode():
        k9, k9_err = {}, 0.0
        for tps in (8, 16):
            b9, c9 = R._pad_tiles_to(bins, counts, tps)
            kw9 = dict(image_size=S, tiles_x=TX, tps=tps)
            out9 = R.raster_fused_groups(c9, b9, records, face_verts, **kw9)
            plain9 = R.raster_fused_groups_plain(c9, b9, records, **kw9)
            torch.cuda.synchronize()
            # against phase 4's K1b render: the tiles past Tp pad the groups
            for nm, a, b, c in zip(("p2f", "zbuf", "nx", "ny", "nz"), out9, plain9, k1b):
                check(torch.equal(a, b), f"K9 {nm} == plain (the group walk) at tps {tps} "
                      "(bitwise)")
                check(torch.equal(a[:, :Tp], c), f"K9 {nm} == K1b at tps {tps} (bitwise, "
                      f"{c9.shape[1] - Tp} padding tiles)")
                k9_err = max(k9_err, float((a.double() - b.double()).abs().max()))
            k9[tps] = (c9, b9, R.group_windows(c9, CPT, tps))
        c10, b10, o10, inv10 = R.sort_tiles_order(*R._pad_tiles_to(bins, counts, 8))
        kw10 = dict(image_size=S, tiles_x=TX, tps=8)
        out10 = R.raster_fused_groups_local(c10, b10, o10, records, face_verts, **kw10)
        plain10 = R.raster_fused_groups_local_plain(c10, b10, o10, records, **kw10)
        torch.cuda.synchronize()
        k10_err = 0.0
        for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), out10, plain10):
            check(torch.equal(a, b), f"K10 {nm} == plain (bitwise)")
            k10_err = max(k10_err, float((a.double() - b.double()).abs().max()))
        img10 = [R._tiles_to_image(torch.gather(o, 1, inv10[..., None].expand_as(o)), S)
                 for o in out10]
        img1b = [R._tiles_to_image(o, S) for o in k1b]
        k10_bad = tie_mismatches(img10[0], img1b[0], img10[1], img1b[1], face_verts, S)
        agree10 = img10[0] == img1b[0]
        dn10 = max(float(((a - b).abs() - 1e-3 * b.abs())[agree10].max())
                   for a, b in zip(img10[2:], img1b[2:]))
        check(dn10 <= 2e-4, f"K10 normals within 2e-4 + 1e-3 x |n| of K1b where "
              f"pix_to_face agrees (worst excess {dn10:.3g}); {k10_bad} tie pixels")
        # K11 on the Morton-ordered face region, the original ids in lane 12
        tmpl = np.asarray(bundle["v_template"])[renderer.kept_vertices]
        perm = R.spatial_face_order(tmpl, renderer.faces.cpu().numpy())
        perm_t = torch.as_tensor(perm, device=dev)
        fv_perm, fn_perm = face_verts[:, perm_t], face_normals[:, perm_t]
        k11, k11_err = {}, 0.0
        for ch, cap11 in ((8, 128), (16, 96), (32, 64)):
            while True:
                c11, l11, r11, f11, d11 = R.chunkskip_inputs(fv_perm, fn_perm, S, ch, cap11,
                                                             perm_t)
                if int(d11.max()) == 0:
                    break
                log(f"    chunk {ch}: {int(d11.sum())} chunks dropped at cap {cap11}; "
                    f"raising the cap to {cap11 * 2}")
                cap11 *= 2
            kw11 = dict(image_size=S, tiles_x=TX, chunk=ch)
            out11 = R.raster_chunkskip(c11, l11, r11, f11, **kw11)
            plain11 = R.raster_chunkskip_plain(c11, l11, r11, **kw11)
            torch.cuda.synchronize()
            for nm, a, b in zip(("p2f", "zbuf", "nx", "ny", "nz"), out11, plain11):
                check(torch.equal(a, b), f"K11 {nm} == plain at chunk {ch}, cap {cap11} "
                      "(bitwise)")
                k11_err = max(k11_err, float((a.double() - b.double()).abs().max()))
            img11 = [R._tiles_to_image(o, S) for o in out11[:2]]
            bad11 = tie_mismatches(img11[0], k1_img[0], img11[1], k1_img[1], face_verts, S)
            log(f"    K11 chunk {ch}, cap {cap11}: {int(c11.sum())} binned chunks "
                f"(max {int(c11.max())} per tile; lists ending in a partial step: "
                f"{int(((c11 * ch) % 32 != 0).sum())}), {bad11} tie pixels against K1")
            k11[ch] = (c11, l11, r11, f11, out11)
        # a truncated cap drops the farthest chunks; the nearest still wins
        c8, l8, _, _, out8 = k11[8]
        ct, lt, rt, ft, dt = R.chunkskip_inputs(fv_perm, fn_perm, S, 8, 4, perm_t)
        outt = R.raster_chunkskip(ct, lt, rt, ft, image_size=S, tiles_x=TX, chunk=8)
        check(int(dt.min()) > 0, f"cap 4 drops chunks (min {int(dt.min())}, max "
              f"{int(dt.max())} per image)")
        pos = torch.arange(4, device=dev)
        valid = pos < c8[..., None]
        check(torch.equal(ct, c8.clamp(max=4))
              and torch.equal(lt[..., :4], torch.where(valid, l8[..., :4], 0)),
              "the cap-4 list is the nearest prefix of the full list")
        check(bool((outt[1] >= out8[1]).all()), "the cap-4 depth is never nearer")
        inv_perm = torch.argsort(perm_t)
        wchunk = inv_perm[out8[0].clamp_min(0).long()] // 8  # (B,Tp,P)
        in_prefix = ((wchunk[..., None] == l8[:, :, None, :4]) & valid[:, :, None, :]).any(-1)
        in_prefix &= out8[0] >= 0
        check(torch.equal(outt[0][in_prefix], out8[0][in_prefix]) and bool(in_prefix.any()),
              f"the full render's winner still wins at the {int(in_prefix.sum())} pixels "
              "whose winning chunk the cap-4 list kept")

    # ---------------- 4j. the culled kernels on slivers ----------------
    log("[4j] culled K1 and K8 on a sliver-heavy batch (b2, 224 px, capacity 512)")
    with torch.inference_mode():
        fvs, fns = sliver_faces(dev, S)
        bins_s, counts_s = R.bin_faces_flat(fvs, S, 512)
        recs_s = R.fused_records(fvs, fns)
        check(bool(torch.isinf(R.cull_boxes(fvs, S)[..., 0]).any())
              and bool(torch.isinf(R.cull_boxes_bins(fvs, S)[..., 0]).any()),
              "both cull-box functions leave some faces of the batch unbounded")
        for bud in (budget, None, 64):
            kept_s, drop_s = R._windows(counts_s, bud)
            got = R.raster_fused_windows(kept_s, bins_s, recs_s, fvs, S, TX)
            want = R.raster_fused_windows_plain(kept_s, bins_s, recs_s, S, TX)
            torch.cuda.synchronize()
            for nm, a, b in zip(FIVE, got, want):
                check(torch.equal(a, b), f"slivers, budget {bud}: culled K1 {nm} == plain "
                      "(bitwise)")
        check(int(drop_s.min()) > 0, "budget 64 drops chunks of the sliver batch")
        crec_s, prec_s = R.coverage_records(fvs), R.planes_records(fvs, fns)
        kept_sp = R._windows(counts_s, None)[0]
        check(int(kept_sp.max()) > 2, "some tile of the sliver batch walks more than 2 chunks")
        for nm6, kept_s6 in (("padded", kept_sp), ("2 chunks", kept_sp.clamp(max=2))):
            got = R.raster_coverage_windows(kept_s6, bins_s, crec_s, fvs, S, TX)
            want = R.raster_coverage_windows_plain(kept_s6, bins_s, crec_s, S, TX)
            k3s = R.raster_planes_windows(kept_s6, bins_s, prec_s, fvs, S, TX, 3)
            torch.cuda.synchronize()
            for nm, a, b, c in zip(("p2f", "zbuf", "slot"), got, want, k3s):
                check(torch.equal(a, b) and torch.equal(a, c), f"slivers, {nm6}: culled K6 "
                      f"{nm} == plain and == K3's (bitwise)")
        fv9_s = fvs.reshape(2, -1, 9).contiguous()
        got = R.raster_bins_coverage(counts_s, bins_s, fv9_s, S)
        want = R.raster_bins_coverage_plain(counts_s, bins_s, fv9_s, S)
        torch.cuda.synchronize()
        for nm, a, b in zip(("p2f", "zbuf"), got, want):
            check(torch.equal(a, b), f"slivers: culled K8 {nm} == plain (bitwise)")
        # K8 divides wherever a barycentric may round to -0: at the centre row
        # of a 65 px image this face covers pixels through w_0 = -0
        fvz = torch.tensor([[[[0.0, 1.0, 10.0], [1.0, 2.0 ** -149, 10.0],
                              [-1.0, 0.0, 10.0]]]], device=dev)
        bz, cz = R.bin_faces_flat(fvz, 65, 32)
        got = R.raster_bins_coverage(cz, bz, fvz.reshape(1, 1, 9), 65)
        want = R.raster_bins_coverage_plain(cz, bz, fvz.reshape(1, 1, 9), 65)
        check(all(torch.equal(a, b) for a, b in zip(got, want))
              and int((want[0][0, 32, :65] == 0).sum()) >= 3,
              "K8 == plain on a face covering pixels through a -0 barycentric")

    if args.quick:
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": count}}))
        return 0

    # ---------------- 5. main path ----------------
    log(f"[5] main path: Predictor -> SmirkSystem.infer at b{B}, {S} px, fp32")
    R.reset_launch_counts()
    out = pred(images)
    launches = {k.__name__: k.launches for k in R.KERNELS}
    log(f"    launches on the main path: {launches}")
    check(launches["raster_fused_windows"] > 0 and not hasattr(R, "compact_faces"),
          "the main path went through K1, K2's packing folded into its staging")
    coverage = float(out["rendered_mask"].mean())
    check(coverage > 0.05, f"coverage {coverage:.4f} > 0.05")
    check(int(out["raster_overflow"].max()) == 0, "raster_overflow == 0")
    for k, v in out.items():
        check(np.isfinite(v).all(), f"{k} {v.shape} finite")
    check(out["rendered_img"].shape == (B, S, S, 3) and out["vertices"].shape ==
          (B, vt.shape[0], 3), "output shapes")

    log("    padded layout path: Predictor(raster_compact=0)")
    pred_pad = Predictor(bundle=bundle, raster_compact=0)
    pred_pad.system.encoder.load_state_dict(system.encoder.state_dict())
    R.reset_launch_counts()
    out_pad = pred_pad(images)
    launches_pad = {k.__name__: k.launches for k in R.KERNELS}
    log(f"    launches on the padded path: {launches_pad}")
    check(launches_pad["raster_fused_windows"] > 0, "the padded path went through K1")
    check(np.array_equal(out_pad["pix_to_face"], out["pix_to_face"])
          and np.array_equal(out_pad["rendered_img"], out["rendered_img"]),
          "padded path == compact path")

    log("    against the port's plain CPU path on 2 images")
    pred_cpu = Predictor(bundle=bundle, device="cpu")
    pred_cpu.system.encoder.load_state_dict(system.encoder.state_dict())
    ref = pred_cpu(images[:2])
    got = pred(images[:2])
    for k in ("pose_params", "cam", "shape_params", "expression_params",
              "eyelid_params", "jaw_params", "vertices", "landmarks_fan",
              "landmarks_mp"):
        err = float(np.abs(ref[k] - got[k]).max())
        check(err < 1e-4, f"{k} card vs cpu max |diff| {err:.2e} < 1e-4")
    agree = float((ref["pix_to_face"] == got["pix_to_face"]).mean())
    check(agree >= 0.995, f"pix_to_face card vs cpu agree on {agree:.5f} >= 0.995")

    # ---------------- 5b. the training path ----------------
    from smirk_tpu_torch.config import Config
    from smirk_tpu_torch.train.trainer import SUB_ENCODERS, SmirkSystem

    TB = TRAIN_B
    log(f"[5b] training path: SmirkSystem.train_step at b{TB}, {S} px, fp32, "
        "both parities")
    tsys = SmirkSystem(Config(), bundle)  # the card
    tbatch = bench.train_batch(TB, S, 0)  # bench.py's synthetic batch
    gen_t = torch.Generator(device=dev).manual_seed(0)
    enc0 = {n: p.detach().clone() for n, p in tsys.encoder.named_parameters()}
    gen0 = [p.detach().clone() for p in tsys.generator.parameters()]
    # every step of each parity goes through K1 (the cycle path's inference
    # render) and K3; the cycle path's faces of the last step are kept for
    # K1's b32 time
    fused_call, k1_cycle = R.rasterize_normals_fused, {}

    def fused_capture(fv, fn, *a, **kw):
        k1_cycle["faces"] = (fv, fn)
        return fused_call(fv, fn, *a, **kw)

    R.rasterize_normals_fused = fused_capture
    train_metrics, train_launches = [], {}
    try:
        for parity in (0, 1) * 3:
            R.reset_launch_counts()
            m, taux = tsys.train_step(tbatch, parity, gen_t)
            train_metrics.append(m)
            step = {k.__name__: k.launches for k in R.KERNELS}
            check(all(step[k.__name__] > 0 for k in TRAIN_KERNELS)
                  and step["fold_slots_to_faces"] == 0 and step["segment_moments"] == 0,
                  f"parity {parity} step: K1, K3 and K4's fold launched, and neither K5 "
                  f"nor K4's store ({step})")
            for k, v in step.items():
                train_launches[k] = train_launches.get(k, 0) + v
    finally:
        R.rasterize_normals_fused = fused_call
    with torch.inference_mode():  # K1's inputs on the cycle path's faces
        fv_c, fn_c = k1_cycle["faces"]
        bins_c, counts_c = R.bin_faces_flat(fv_c, S, cap)
        k1_cycle["args"] = (R._windows(counts_c, budget)[0], bins_c,
                            R.fused_records(fv_c, fn_c), fv_c.contiguous(), S, TX)
    torch.cuda.synchronize()
    log(f"    launches over 6 train steps: {train_launches}")
    for i, m in enumerate(train_metrics):
        check(all(math.isfinite(v) for v in m.values()), f"step {i} metrics finite")
        check(m["raster_overflow"] == 0 and m["raster_overflow_2nd"] == 0,
              f"step {i} raster_overflow == raster_overflow_2nd == 0")
    log("    step 0 metrics: " + json.dumps(train_metrics[0]))
    log("    step 5 metrics: " + json.dumps(train_metrics[-1]))
    moved = {sub: sum(float((p.detach() - enc0[n]).abs().sum())
                      for n, p in tsys.encoder.named_parameters() if n.startswith(sub))
             for sub in SUB_ENCODERS}
    gen_moved = sum(float((p.detach() - q).abs().sum())
                    for p, q in zip(tsys.generator.parameters(), gen0))
    check(moved["expression_encoder"] > 0 and gen_moved > 0,
          f"the expression encoder ({moved['expression_encoder']:.4g}) and the "
          f"generator ({gen_moved:.4g}) moved")
    check(moved["pose_encoder"] == 0 and moved["shape_encoder"] == 0,
          "the pose and shape encoders did not move")
    cov_t = float((taux["rendered_img"].sum(-1) > 0).float().mean())
    check(cov_t > 0.05, f"training render coverage {cov_t:.4f} > 0.05")
    log("    padded layout: one train step of each parity with raster_compact=0")
    tsys.renderer.raster_compact = 0
    train_launches_pad = {}
    for parity in (0, 1):
        R.reset_launch_counts()
        m, _ = tsys.train_step(tbatch, parity, gen_t)
        check(all(math.isfinite(v) for v in m.values()), f"padded parity {parity} finite")
        step = {k.__name__: k.launches for k in R.KERNELS}
        check(step["raster_fused_windows"] > 0 and step["raster_planes_windows"] > 0,
              f"padded parity {parity} step: K1 and K3 launched")
        for k, v in step.items():
            train_launches_pad[k] = train_launches_pad.get(k, 0) + v
    tsys.renderer.raster_compact = renderer.raster_compact
    log(f"    launches on the padded training path: {train_launches_pad}")

    # ---------------- 5c. the op path ----------------
    from smirk_tpu_torch import ops
    from smirk_tpu_torch.flame.model import FlameModel
    from smirk_tpu_torch.render.shading import GRAY_ALBEDO

    log(f"[5c] op path: FLAME -> ops.rasterize (D=9) -> point + SH shading -> L2 -> "
        f"d expression, b{OP_B}, {S} px, fp32")
    op_flame = FlameModel(bundle)  # the card
    rng = np.random.default_rng(0)

    def seeded(*shape, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32, device=dev)

    op_params = {"shape_params": seeded(OP_B, 300, scale=0.5),
                 "expression_params": seeded(OP_B, 50, scale=0.5),
                 "pose_params": seeded(OP_B, 3, scale=0.05),
                 "jaw_params": seeded(OP_B, 3, scale=0.05).abs(),
                 "eyelid_params": seeded(OP_B, 2).abs().clamp(max=1)}
    op_cam = torch.tensor([[7.0, 0.0, 0.0]] * OP_B, device=dev)
    light_pos = torch.tensor([[[-1.0, 1.0, 1.0], [1.0, 1.0, 2.0]]] * OP_B, device=dev)
    light_int = torch.full((OP_B, 2, 3), 1.5, device=dev)
    sh_coeff = seeded(OP_B, 9, 3, scale=0.3)
    op_target = torch.tensor(rng.random((OP_B, S, S, 3)), dtype=torch.float32, device=dev)
    faces, kept_v = renderer.faces, renderer.kept

    def op_path(expr, capacity):
        """-> (loss, face_verts, attributes, vals, mask, p2f, overflow)."""
        verts = op_flame({**op_params, "expression_params": expr})["vertices"]
        tv = ops.orth_proj_ndc(verts, op_cam)[:, kept_v]
        tv = torch.cat([tv[..., :2], tv[..., 2:] + 10.0], -1)  # the renderer's z offset
        sub_v = verts[:, kept_v]
        normals = ops.vertex_normals_gather(sub_v, faces, renderer.inc_face,
                                            renderer.inc_corner)
        fv = ops.face_vertices(tv, faces)
        fn = ops.face_vertices(normals, faces)
        attrs = torch.cat([torch.full_like(fn, GRAY_ALBEDO), ops.face_vertices(sub_v, faces),
                           fn], -1)
        vals, mask, p2f, ovf = ops.rasterize(fv, attrs, S, capacity)
        pos, nrm = vals[..., 3:6], vals[..., 6:9]
        point = ops.point_shading(pos.reshape(OP_B, -1, 3), nrm.reshape(OP_B, -1, 3),
                                  light_pos, light_int).reshape(OP_B, S, S, 3)
        img = vals[..., :3] * (point + ops.sh_shading(nrm, sh_coeff)) * mask
        return ((img - op_target) ** 2).mean(), fv, attrs, vals, mask, p2f, ovf

    op_grad_ratio = 0.0
    gather_fn, gathers = R._gather_recs, [0]

    def gather_counted(*a, **kw):
        gathers[0] += 1
        return gather_fn(*a, **kw)

    for c5 in (512, cap):
        expr = op_params["expression_params"].clone().requires_grad_(True)
        R.reset_launch_counts()
        R._gather_recs, gathers[0] = gather_counted, 0
        try:
            loss, fv5, at5, vals5, mask5, p2f5, ovf5 = op_path(expr, c5)
        finally:
            R._gather_recs = gather_fn
        check(gathers[0] == 0, f"capacity {c5}: the forward gathered no record list")
        g_vals, d_fv5, d_at5, d_exp = torch.autograd.grad(loss, (vals5, fv5, at5, expr))
        torch.cuda.synchronize()
        launched = {k.__name__: k.launches for k in R.KERNELS}
        if c5 == 512:
            op_launches, fv_op, p2f_op = launched, fv5.detach(), p2f5
        log(f"    capacity {c5}: loss {float(loss.detach()):.6f}; launches {launched}")
        check(all(launched[k.__name__] > 0 for k in (R.raster_coverage_windows,
                                                     R.segment_reduce_tiles,
                                                     R.fold_slots_to_faces))
              and launched["raster_planes_windows"] == 0
              and launched["segment_moments"] == 0
              and launched["segment_moments_to_faces"] == 0,
              "the op path went through K6, K7 and K5, and not K3 or K4")
        cov5 = float(mask5.mean())
        check(cov5 > 0.05, f"coverage {cov5:.4f} > 0.05")
        check(int(ovf5.abs().max()) == 0, "overflow == 0")
        for nm, t in (("loss", loss), ("vals", vals5), ("d vals", g_vals),
                      ("d face_verts", d_fv5), ("d attributes", d_at5),
                      ("d expression", d_exp)):
            check(bool(torch.isfinite(t).all()), f"{nm} {tuple(t.shape)} finite")
        check(float(d_exp.abs().max()) > 0, "the gradient reaches the expression")
        fv5, at5 = fv5.detach(), at5.detach()
        check(torch.equal(vals5.detach(), R.interpolate_attributes(p2f5, fv5, at5)[0]),
              "vals == interpolate_attributes(p2f, ...) (bitwise)")
        ref_fv, sc_fv, ref_at, sc_at = R.dense_gradient_and_scale(
            p2f5, fv5, at5, g_vals, weighted=False)
        op_grad_ratio = max(
            op_grad_ratio,
            within(d_fv5, ref_fv, sc_fv, f"d face_verts vs dense at capacity {c5}")[0],
            within(d_at5, ref_at, sc_at, f"d attributes vs dense at capacity {c5}")[0])

    log("    the coverage entry points on the same faces")
    with torch.inference_mode():
        R.reset_launch_counts()
        p2f_cov, z_cov = ops.rasterize_coverage(fv_op, S, 512)
        cov_launches = {k.__name__: k.launches for k in R.KERNELS}
        R.reset_launch_counts()
        p2f_k8, z_k8 = ops.rasterize_coverage_pallas(fv_op, S, cap)
        k8_launches = {k.__name__: k.launches for k in R.KERNELS}
        torch.cuda.synchronize()
    check(cov_launches["raster_coverage_windows"] == 1 and sum(cov_launches.values()) == 1,
          "rasterize_coverage launched K6 once and nothing else")
    check(k8_launches["raster_bins_coverage"] == 1 and sum(k8_launches.values()) == 1,
          "rasterize_coverage_pallas launched K8 once and nothing else")
    check(torch.equal(p2f_cov, p2f_op), "rasterize_coverage pix_to_face == the op path's")
    with torch.inference_mode():  # the rows K7 reads on the op path's backward
        slots_op = R.image_to_tiles(R._v3_impl(fv_op, S, 512)[2], S)
    rows_op = int(((slots_op >= 0) & (slots_op < 512)).sum())
    covered_op = int((p2f_op >= 0).sum())
    log(f"    the op path's K7 reads {rows_op} of {slots_op.numel()} payload rows "
        f"({rows_op / slots_op.numel() * 100:.1f} %: {covered_op} covered pixels, "
        f"{rows_op - covered_op} padding pixels with slot 0)")
    log(f"    K8 vs K6 on the op path's faces: "
        f"{tie_mismatches(p2f_k8, p2f_cov, z_k8, z_cov, fv_op, S)} tie pixels")

    # ---------------- 5d. the scheduled rasters' path ----------------
    log(f"[5d] scheduled rasters: rasterize_normals_fused(merged / sort_tiles) and "
        f"rasterize_normals_chunkskip (8, 128) at b{B}, {S} px, capacity {cap}")
    with torch.inference_mode():
        R.reset_launch_counts()
        sched = {
            "merged": R.rasterize_normals_fused(face_verts, face_normals, S, cap,
                                                merged=True, return_overflow=True),
            "sort_tiles": R.rasterize_normals_fused(face_verts, face_normals, S, cap,
                                                    sort_tiles=True, return_overflow=True),
            "chunkskip": R.rasterize_normals_chunkskip(fv_perm, fn_perm, S, 8, 128,
                                                       return_overflow=True, face_ids=perm_t),
        }
        torch.cuda.synchronize()
        sched_launches = {k.__name__: k.launches for k in R.KERNELS}
    log(f"    launches on the scheduled rasters' path: {sched_launches}")
    check(all(sched_launches[k.__name__] > 0 for k in (
        R.raster_fused_groups, R.raster_fused_groups_local, R.raster_chunkskip)),
        "the path went through K9, K10 and K11")
    for nm, (n5, p5, z5, o5) in sched.items():
        cov5 = float((p5 >= 0).float().mean())
        check(cov5 > 0.05, f"{nm}: coverage {cov5:.4f} > 0.05")
        check(all(bool(torch.isfinite(t).all()) for t in (n5, z5)), f"{nm}: outputs finite")
        check(int(o5.max()) == 0, f"{nm}: nothing dropped")
        log(f"    {nm} vs the compact K1 render: "
            f"{tie_mismatches(p5, k1_img[0], z5, k1_img[1], face_verts, S)} tie pixels")

    # ---------------- 6. timings ----------------
    log(f"[6] timings {card}")
    res, kernel_calls = {}, {}

    def kernel_ms(key, fn, iters, warmup=2):
        """res[key]: a kernel row's call timed as cuda_ms does (the host
        launching each call); the call is kept for its device time."""
        kernel_calls[key] = fn
        res[key] = cuda_ms(fn, iters, warmup)

    with torch.inference_mode():
        # K2's packing is folded into K1's and K3's staging: what the compact
        # layout still computes in its place is the kept counts (`_windows`)
        kernel_ms("windows_ms", lambda: R._windows(counts, budget), 200)
        starts, _, tof, total, _ = R._compact_plan(counts, budget)
        bins3 = bins.reshape(B, Tp * CPT, R.V3_CHUNK)
        res["k2_plain_ms"] = cuda_ms(
            lambda: R.compact_faces_plain(tof, starts, total, bins3, CPT), 50)
        rows = (tof * CPT + torch.arange(budget, device=tof.device)[None]
                - torch.gather(starts, 1, tof.long())).clamp(0, Tp * CPT - 1).long()
        bidx = torch.arange(B, device=tof.device)[:, None]
        # yardstick of K2's function: one advanced-index gather of the same rows
        res["k2_library_ms"] = cuda_ms(lambda: bins3[bidx, rows], 200)
        kernel_ms("k1_ms", 
            lambda: R.raster_fused_windows(kept, bins, records, face_verts, S, TX), 50)
        # the same launch without the custom op's dispatch (K1's CUDA
        # implementation called directly): the op's host cost is the difference
        res["k1_direct_ms"] = cuda_ms(
            lambda: R._k1_cuda(kept, bins, records, face_verts, S, TX), 50)
        res["k1_plain_ms"] = cuda_ms(
            lambda: R.raster_fused_windows_plain(kept, bins, records, S, TX), 5, 1)
        kernel_ms("k1b_ms", 
            lambda: R.raster_fused_windows(kept_p, bins, records, face_verts, S, TX), 50)
        res["k1b_plain_ms"] = cuda_ms(
            lambda: R.raster_fused_windows_plain(kept_p, bins, records, S, TX), 5, 1)
        # K1 on the cycle path's faces of the last train step (b32)
        kernel_ms("k1_b32_cycle_ms", 
            lambda: R.raster_fused_windows(*k1_cycle["args"]), 50)

        def records_plan():
            R.fused_records(face_verts, face_normals)
            return R._windows(counts, budget)

        # stage breakdown of one infer call (K1 itself is k1_ms above)
        stages = {
            "encoder": lambda: system.encoder(img),
            "flame": lambda: system.flame(enc),
            "render_inference": lambda: renderer.render_inference(fl["vertices"], tv),
            "face_geometry": lambda: renderer._face_geometry(fl["vertices"], tv),
            "bin_faces_flat": lambda: R.bin_faces_flat(face_verts, S, cap),
            "records_plan": records_plan,
            # K3 with its inputs, as a train step runs it once (b32)
            "planes_forward_b32": lambda: R._v5_impl(fvt, fnt, S, cap, budget),
        }
        for k, fn in stages.items():
            res[f"stage_{k}_ms"] = cuda_ms(fn, 10)
        kernel_ms("k3_ms", 
            lambda: R.raster_planes_windows(kept3, bins_t, prec, fvt, S, TX, D), 50)
        res["k3_plain_ms"] = cuda_ms(
            lambda: R.raster_planes_windows_plain(kept3, bins_t, prec, S, TX, D), 3, 1)
        kernel_ms("k3b_ms", 
            lambda: R.raster_planes_windows(kept3p, bins_t, prec, fvt, S, TX, D), 50)
        res["k3b_plain_ms"] = cuda_ms(
            lambda: R.raster_planes_windows_plain(kept3p, bins_t, prec, S, TX, D), 3, 1)
        # K4: its fold epilogue (the training backward's launch), then its
        # store epilogue and K5 at the same shapes, the per-slot route
        kernel_ms("k4_ms", 
            lambda: R.segment_moments_to_faces(slots3, g_t, bins_t, cap, S, F_render), 200)
        res["k4_plain_ms"] = cuda_ms(lambda: R.segment_moments_to_faces_plain(
            slots3, g_t, bins_t, cap, S, F_render), 20)
        # yardstick of the fold: one index_add_ of prebuilt moment rows by a
        # prebuilt pixel -> face row index (dropped pixels to a last row)
        rows4 = R.moment_rows(g_t, S).reshape(-1, 3 * D)
        ids4 = torch.gather(bins_t, 2, slots3.clamp(0, cap - 1).long())
        held4 = (slots3 >= 0) & (slots3 < cap) & (ids4 >= 0) & (ids4 < F_render)
        idx4 = torch.where(held4, torch.arange(BT, device=dev)[:, None, None] * F_render
                           + ids4, BT * F_render).reshape(-1)
        buf4 = torch.zeros((BT * F_render + 1, 3 * D), device=dev)
        res["k4_library_ms"] = cuda_ms(lambda: buf4.index_add_(0, idx4, rows4), 200)
        kernel_ms("k4_store_ms", lambda: R.segment_moments(slots3, g_t, cap, S), 200)
        res["k4_store_plain_ms"] = cuda_ms(
            lambda: R.segment_moments_plain(slots3, g_t, cap, S), 20)
        # yardstick of the store: the one scatter_add_ of prebuilt moment rows
        idx4s = R.slot_index(slots3, cap, 3 * D)
        buf4s = torch.zeros((BT, Tp * cap + 1, 3 * D), device=dev)
        rows4s = rows4.reshape(BT, -1, 3 * D)
        res["k4_store_library_ms"] = cuda_ms(lambda: buf4s.scatter_add_(1, idx4s, rows4s), 200)
        kernel_ms("k5_train_ms", lambda: R.fold_slots_to_faces(k4, bins_t, F_render), 200)
        kernel_ms("k4_store_then_k5_ms", lambda: R.fold_slots_to_faces(
            R.segment_moments(slots3, g_t, cap, S), bins_t, F_render), 200)
        # K5 where it is served: the op path's K7 rows, C=512, CHN=36
        kernel_ms("k5_ms", lambda: R.fold_slots_to_faces(pay5, b5op, F_render), 200)
        res["k5_plain_ms"] = cuda_ms(
            lambda: R.fold_slots_to_faces_plain(pay5, b5op, F_render), 20)
        # yardstick: the one index_add_ of the same rows into the face table
        idx5 = R._fold_index(b5op, F_render)
        src5 = pay5.reshape(-1, 36)
        buf5 = torch.zeros((BT * F_render + 1, 36), device=dev)
        res["k5_library_ms"] = cuda_ms(lambda: buf5.index_add_(0, idx5, src5), 200)
        b6, kept6, _ = k6[512]
        kernel_ms("k6_ms", 
            lambda: R.raster_coverage_windows(kept6, b6, crec, fvt, S, TX), 50)
        res["k6_plain_ms"] = cuda_ms(
            lambda: R.raster_coverage_windows_plain(kept6, b6, crec, S, TX), 3, 1)
        # the coverage forward with its inputs (binning, records, K6), b32
        res["call_coverage_b32_ms"] = cuda_ms(lambda: R._v3_impl(fvt, S, 512), 20)
        kernel_ms("k7_ms", lambda: R.segment_reduce_tiles(slots7, pay7, 512), 100)
        res["k7_plain_ms"] = cuda_ms(lambda: R.segment_sum(slots7, pay7, 512), 20)
        # yardstick: the one scatter_add_ of the payload rows, index prebuilt
        idx7 = R.slot_index(slots7, 512, 36)
        rows7 = pay7.reshape(BT, -1, 36)
        buf7 = torch.zeros((BT, Tp * 512 + 1, 36), device=dev)
        res["k7_library_ms"] = cuda_ms(lambda: buf7.scatter_add_(1, idx7, rows7), 100)
        kernel_ms("k8_ms", lambda: R.raster_bins_coverage(counts_t, bins_t, fv9, S), 20)
        res["k8_plain_ms"] = cuda_ms(
            lambda: R.raster_bins_coverage_plain(counts_t, bins_t, fv9, S), 3, 1)
        for tps in (8, 16):
            c9, b9, _ = k9[tps]
            kernel_ms(f"k9_tps{tps}_ms", lambda c9=c9, b9=b9, tps=tps: R.raster_fused_groups(
                c9, b9, records, face_verts, image_size=S, tiles_x=TX, tps=tps), 50)
        res["k9_plain_ms"] = cuda_ms(lambda: R.raster_fused_groups_plain(
            k9[8][0], k9[8][1], records, image_size=S, tiles_x=TX, tps=8), 5, 1)
        kernel_ms("k10_ms", lambda: R.raster_fused_groups_local(
            c10, b10, o10, records, face_verts, **kw10), 50)
        res["k10_plain_ms"] = cuda_ms(lambda: R.raster_fused_groups_local_plain(
            c10, b10, o10, records, **kw10), 5, 1)
        for ch, (c11, l11, r11, f11, _) in k11.items():
            kernel_ms(f"k11_ch{ch}_ms", lambda c11=c11, l11=l11, r11=r11, f11=f11, ch=ch:
                      R.raster_chunkskip(c11, l11, r11, f11, image_size=S, tiles_x=TX,
                                         chunk=ch), 50)
        res["k11_plain_ms"] = cuda_ms(lambda: R.raster_chunkskip_plain(
            *k11[8][:3], image_size=S, tiles_x=TX, chunk=8), 5, 1)
        # the whole inference raster calls, binning and records included
        whole = {
            "compact": lambda: R.rasterize_normals_fused(face_verts, face_normals, S, cap,
                                                         compact=budget),
            "padded": lambda: R.rasterize_normals_fused(face_verts, face_normals, S, cap),
            "merged": lambda: R.rasterize_normals_fused(face_verts, face_normals, S, cap,
                                                        merged=True),
            "sort_tiles": lambda: R.rasterize_normals_fused(face_verts, face_normals, S, cap,
                                                            sort_tiles=True),
            "chunkskip": lambda: R.rasterize_normals_chunkskip(fv_perm, fn_perm, S, 8, 128,
                                                               face_ids=perm_t),
        }
        for k, fn in whole.items():
            res[f"call_{k}_ms"] = cuda_ms(fn, 20)
        res["bin_chunks_8_128_ms"] = cuda_ms(lambda: R.bin_chunks(
            R._pad_faces_offscreen(fv_perm, 8)[0], S, 8, 128), 20)
        # the kernel rows' calls on the device alone: a call shorter than its
        # Python and launch costs is paced by the host in the times above
        dev_ms = {k: kernels.graph_ms(fn, GRAPH_CALLS) for k, fn in kernel_calls.items()}
    # the op path at b32, capacity 512: forward (FLAME -> loss) and backward
    # to the expression, CUDA events, median of 5 warm passes
    expr_t = op_params["expression_params"].clone().requires_grad_(True)
    op_fwd, op_bwd = [], []
    for i in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss_t = op_path(expr_t, 512)[0]
        ev[1].record()
        torch.autograd.grad(loss_t, expr_t)
        ev[2].record()
        torch.cuda.synchronize()
        if i:
            op_fwd.append(ev[0].elapsed_time(ev[1]))
            op_bwd.append(ev[1].elapsed_time(ev[2]))
    res["op_path_forward_ms"] = statistics.median(op_fwd)
    res["op_path_backward_ms"] = statistics.median(op_bwd)
    # end to end: warm windows of back-to-back calls, each window ended by a
    # synchronize, on the host clock; the median window and the spread
    infer_w = timed_windows(lambda: system.infer(img), INFER_WINDOWS, INFER_CALLS)
    call_w = timed_windows(lambda: pred(images), CALL_WINDOWS, CALL_CALLS)
    infer_ms, call_ms = statistics.median(infer_w), statistics.median(call_w)
    train_w = {p: timed_windows(lambda p=p: tsys.train_step(tbatch, p, gen_t),
                                TRAIN_WINDOWS, TRAIN_STEPS) for p in (0, 1)}
    stage_runs = {p: [train_stages(tsys, tbatch, p, gen_t) for _ in range(3)] for p in (0, 1)}
    profiles = {p: profile_train_step(tsys, tbatch, p, gen_t) for p in (0, 1)}
    conv_flops = {p: conv_flops_of_step(tsys, tbatch, p, gen_t) for p in (0, 1)}
    occ = renderer.measure_compact_occupancy(fl["vertices"], enc["cam"])
    for k, v in res.items():
        log(f"    {k:32s} {v:10.4f} ms {card}")
    for k, v in dev_ms.items():
        log(f"    {k:32s} {v:10.4f} ms on the device (a CUDA graph of {GRAPH_CALLS} "
            f"calls) {card}")
    log(f"    infer ms/batch{B} median {infer_ms:.3f} over {INFER_WINDOWS} windows of "
        f"{INFER_CALLS} calls (min {infer_w[0]:.3f}, max {infer_w[-1]:.3f}, spread "
        f"{spread(infer_w):.1f} %)  images/s {B / infer_ms * 1e3:.1f} {card}")
    log(f"    Predictor.__call__ ms/batch{B} (host preparation + D2H included) median "
        f"{call_ms:.3f} over {CALL_WINDOWS} windows of {CALL_CALLS} calls (min "
        f"{call_w[0]:.3f}, max {call_w[-1]:.3f}, spread {spread(call_w):.1f} %)  "
        f"images/s {B / call_ms * 1e3:.1f} {card}")
    train_ms = {p: statistics.median(w) for p, w in train_w.items()}
    for p, w in train_w.items():
        log(f"    train_ms_batch{TB}_fp32_p{p} median {train_ms[p]:.3f} over "
            f"{TRAIN_WINDOWS} windows of {TRAIN_STEPS} steps (min {w[0]:.3f}, max "
            f"{w[-1]:.3f}, spread {spread(w):.1f} %) {card}")
    log(f"    train_ms_batch{TB}_fp32_avg {(train_ms[0] + train_ms[1]) / 2:.3f} {card}")
    for p, runs in stage_runs.items():
        med = [statistics.median(r[i] for r in runs) for i in range(3)]
        log(f"    train stages p{p} (median of 3, ms): phase1_forward {med[0]:.3f} "
            f"phase1_backward_adam {med[1]:.3f} phase2 {med[2]:.3f} {card}")
    for p, prof in profiles.items():
        if prof is None:
            log(f"    train profile p{p}: no device time in the trace; not measured")
            continue
        wall, by_class = prof
        busy = sum(by_class.values())
        log(f"    train profile p{p} (one step, torch.profiler): wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms ({busy / wall * 100:.1f} %, idle "
            f"{100 - busy / wall * 100:.1f} %) {card}")
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            log(f"      {cls:28s} {ms:9.3f} ms  {ms / busy * 100:5.1f} % of device time")
        conv_ms = by_class.get("convolution", 0.0)
        if conv_ms > 0:
            log(f"      convolutions: {conv_flops[p] / 1e12:.4f} TFLOP per step (forward "
                f"hooks) in {conv_ms:.3f} ms = {conv_flops[p] / conv_ms / 1e9:.2f} "
                f"TFLOP/s, {conv_flops[p] / conv_ms / 1e9 / (PEAK_FP32_FLOPS / 1e12) * 100:.1f}"
                f" % of the fp32 peak {card}")
    for p in (0, 1):
        log(f"    convolution TFLOP per train step p{p}: {conv_flops[p] / 1e12:.4f}")
    log(f"    occupied chunks (max over images) {occ['occupied_chunks']} vs budget "
        f"{occ['budget']} (headroom {occ['headroom']:.3f}); mean "
        f"{float(occupied.float().mean()):.1f}")

    # ---------------- 5e. the reconstruct path ----------------
    # after the timings of [6], so that they run on the process state of
    # the phases before them; its launches are counted with their own reset
    rec_launches = reconstruct_phase(bundle, system.encoder.state_dict(), out, B, S, card)
    # ---------------- 5f-5h. the training CLI, the bench line, F1 ----------------
    cli_info = train_cli_phase(bundle, images, S, train_ms, card)
    log("    " + json.dumps(cli_info))
    bench_line = bench_phase(card)
    f1_phase(system, img)
    # ---------------- 5i. serving ----------------
    serve_info = serving_phase(system, images, img, infer_w, bench_line, card)
    log("    " + json.dumps(serve_info))
    # ---------------- 5j-5k. precision, the teachers ----------------
    prec_info, prec_launches = precision_phase(bundle, img, bench_line, card)
    log("    " + json.dumps(prec_info))
    teach_info, teach_launches = teachers_phase(bundle, train_ms, card)
    log("    " + json.dumps(teach_info))

    # ---------------- 7. kernels line ----------------
    win_c = int(kept.sum())
    win_p = int(kept_p.sum())
    n_tiles = B * Tp
    # K1's and K3's bounds count what their function needs on these inputs
    # (the pairs in the faces' boxes, the binned records read once); the
    # count of every slot against every pixel is printed beside them
    raw = torch.stack(R._bbox_and_priority(face_verts, S)[:4], -1)
    boxes1 = R.cull_boxes(face_verts, S)  # as K1 computes them in its staging
    work1 = culled_work(kept, bins, raw, S, boxes1)
    work1p = culled_work(kept_p, bins, raw, S, boxes1)
    k1_bms, k1_by = culled_bound(work1, n_tiles, 5, 3)
    k1b_bms, k1b_by = culled_bound(work1p, n_tiles, 5, 3)
    k1_old_bms, _ = raster_bound(win_c, n_tiles, 5, 3, B, Tp)
    k1b_old_bms, _ = raster_bound(win_p, n_tiles, 5, 3, B, Tp)
    work3 = culled_work(kept3, bins_t, raw_t, S, boxes_t)
    work3p = culled_work(kept3p, bins_t, raw_t, S, boxes_t)
    k3_bms, k3_by = culled_bound(work3, BT * Tp, 3 + D, D)
    k3b_bms, k3b_by = culled_bound(work3p, BT * Tp, 3 + D, D)
    k3_old_bms, _ = raster_bound(work3["chunk_steps"], BT * Tp, 3 + D, D, BT, Tp)
    k3b_old_bms, _ = raster_bound(work3p["chunk_steps"], BT * Tp, 3 + D, D, BT, Tp)
    # K4's fold needs the slots, g at the pixels with a live slot, the bin
    # ids of the slots a live pixel reached (it reads no other) and the
    # face table; the per-slot route (K4's store, then K5) reads all of g
    # and writes and reads back the (B, Tp, C, 3D) table
    k4_live = int(((slots3 >= 0) & (slots3 < cap)).sum())
    k4_won = int(torch.zeros((BT, Tp * cap + 1), device=slots3.device).scatter_(
        1, R.slot_index(slots3, cap, 1)[..., 0], 1.0)[:, :-1].sum())
    k4_bytes = (BT * Tp * R.TILE_PIX * 4 + k4_live * D * 4 + k4_won * 4
                + BT * F_render * 3 * D * 4)
    k4_all_bins_bytes = k4_bytes + (BT * Tp * cap - k4_won) * 4
    k4_store_bytes = BT * Tp * R.TILE_PIX * 4 * (1 + D) + BT * Tp * cap * 3 * D * 4
    k5_train_bytes = BT * Tp * cap * (3 * D + 1) * 4 + BT * F_render * 3 * D * 4
    # K5 on the op path needs the bins, the rows of slots that hold a face and
    # the face table; the count that reads every row beside it
    k5_out_bytes = BT * F_render * 36 * 4
    k5_bytes = b5op.numel() * 4 + k5_rows * 36 * 4 + k5_out_bytes
    k5_all_bytes = b5op.numel() * (36 + 1) * 4 + k5_out_bytes
    # K6 and K8 compute coverage on binned faces: their bounds count the
    # same way (K6's 64-byte records; K8's 36-byte vertices, 29 operations
    # a pair), with every binned slot against every pixel printed beside
    work6 = culled_work(kept6, b6, raw_t, S, boxes_t)  # K6 culls with K3's boxes
    k6_bms, k6_by = culled_bound(work6, BT * Tp, 3, 0, rec_bytes=64)
    k6_old_bms, _ = raster_bound(int(kept6.sum()), BT * Tp, 3, 0, BT, Tp, lanes=16)
    # K7 needs the slots, the payload rows of slots in [0, C) and the
    # output; the count that reads every row is printed beside it
    k7_out_bytes = BT * Tp * 512 * 36 * 4
    k7_bytes = BT * Tp * R.TILE_PIX * 4 + k7_rows * 36 * 4 + k7_out_bytes
    k7_all_bytes = BT * Tp * R.TILE_PIX * (36 + 1) * 4 + k7_out_bytes
    T_real = -(-S // R.TILE_ROWS) * TX
    k8_pairs = int(counts_t[:, :T_real].sum()) * R.TILE_PIX
    # K8's cull boxes, as it computes them in its staging
    work8 = culled_work(kept3p, bins_t, raw_t, S, R.cull_boxes_bins(fvt, S))
    k8_bms, k8_by = culled_bound(work8, BT * Tp, 2, 0, rec_bytes=36,
                                 ops_per_pair=OPS_PER_FACE_PIXEL_K8)
    k8_old_bms, _ = bound(k8_pairs * OPS_PER_FACE_PIXEL_K8,
                          BT * Tp * 4 + int(counts_t.sum()) * 4 + BT * F_render * 9 * 4
                          + 2 * BT * T_real * R.TILE_PIX * 4)
    # the kept counts that stand where K2 stood: counts read, kept and
    # overflow written
    windows_bytes = B * Tp * 4 * 2 + B * 4
    # K9 and K10 compute K1b's function on the same faces (K9's bound is
    # K1b's); K10 culls with the rebase's boxes. K11 computes K1's
    # z-buffer over its chunk lists: its bound counts the pairs in the boxes
    # of the binned chunks' faces and every record of those chunks, which it
    # must read. What the plain schedules walk past the function is printed
    # below.
    s9, e9 = k9[8][2]
    s10, e10 = R.group_windows(c10, CPT, 8)
    work10 = culled_work(kept_p, bins, raw, S, R.cull_boxes_local(face_verts, S))
    k10_bms, k10_by = culled_bound(work10, n_tiles, 5, 3)
    work11 = {ch: chunk_work(*k11[ch][:4], ch, S) for ch in k11}
    k11_bounds = {ch: culled_bound(w, n_tiles, 5, 3) for ch, w in work11.items()}
    src = "smirk_tpu_torch/csrc/"
    line = {"kernels": [
        {"name": "compact_faces", "route": "folded into K1/K3 staging",
         "source": src + "raster_fused.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1257",
         "launches": 0, "max_abs_err": k2_err,
         "ms": res["windows_ms"], "device_ms": dev_ms["windows_ms"],
         "plain_ms": res["k2_plain_ms"],
         "bound_ms": windows_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": res["k2_library_ms"]},
        {"name": "raster_fused_windows", "route": "cuda", "source": src + "raster_fused.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1331",
         "launches": launches["raster_fused_windows"] + rec_launches["raster_fused_windows"]
         + serve_info["launches"] + prec_launches.get("raster_fused_windows", 0)
         + teach_launches.get("raster_fused_windows", 0),
         "max_abs_err": k1_err,
         "ms": res["k1_ms"], "device_ms": dev_ms["k1_ms"],
         "direct_ms": res["k1_direct_ms"], "plain_ms": res["k1_plain_ms"],
         "bound_ms": k1_bms, "bound_by": k1_by, "library_ms": None},
        {"name": "raster_fused_windows (padded layout)", "route": "cuda",
         "source": src + "raster_fused.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1157",
         "launches": launches_pad["raster_fused_windows"], "max_abs_err": k1b_err,
         "ms": res["k1b_ms"], "device_ms": dev_ms["k1b_ms"],
         "plain_ms": res["k1b_plain_ms"],
         "bound_ms": k1b_bms, "bound_by": k1b_by, "library_ms": None},
        {"name": "raster_planes_windows", "route": "cuda", "source": src + "raster_planes.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:2443",
         "launches": train_launches["raster_planes_windows"]
         + prec_launches.get("raster_planes_windows", 0)
         + teach_launches.get("raster_planes_windows", 0), "max_abs_err": k3_err,
         "ms": res["k3_ms"], "device_ms": dev_ms["k3_ms"],
         "plain_ms": res["k3_plain_ms"],
         "bound_ms": k3_bms, "bound_by": k3_by, "library_ms": None},
        {"name": "raster_planes_windows (padded layout)", "route": "cuda",
         "source": src + "raster_planes.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:2382",
         "launches": train_launches_pad["raster_planes_windows"], "max_abs_err": k3b_err,
         "ms": res["k3b_ms"], "device_ms": dev_ms["k3b_ms"],
         "plain_ms": res["k3b_plain_ms"],
         "bound_ms": k3b_bms, "bound_by": k3b_by, "library_ms": None},
        {"name": "segment_moments_to_faces", "route": "cuda",
         "source": src + "segment_moments.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:2225",
         "launches": train_launches["segment_moments_to_faces"]
         + prec_launches.get("segment_moments_to_faces", 0)
         + teach_launches.get("segment_moments_to_faces", 0), "max_abs_err": k4f_err,
         "ms": res["k4_ms"], "device_ms": dev_ms["k4_ms"],
         "plain_ms": res["k4_plain_ms"],
         "bound_ms": k4_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": res["k4_library_ms"], "store_ms": res["k4_store_ms"],
         "store_device_ms": dev_ms["k4_store_ms"],
         "every_bin_bound_ms": k4_all_bins_bytes / PEAK_HBM_BYTES * 1e3,
         "per_slot_bound_ms": (k4_store_bytes + k5_train_bytes) / PEAK_HBM_BYTES * 1e3},
        {"name": "fold_slots_to_faces", "route": "cuda", "source": src + "fold_faces.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:2120",
         "launches": op_launches["fold_slots_to_faces"], "max_abs_err": k5op_err,
         "ms": res["k5_ms"], "device_ms": dev_ms["k5_ms"],
         "plain_ms": res["k5_plain_ms"],
         "bound_ms": k5_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": res["k5_library_ms"], "train_shape_ms": res["k5_train_ms"],
         "train_shape_device_ms": dev_ms["k5_train_ms"],
         "every_row_bound_ms": k5_all_bytes / PEAK_HBM_BYTES * 1e3},
        {"name": "raster_coverage_windows", "route": "cuda",
         "source": src + "raster_coverage.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:936",
         "launches": op_launches["raster_coverage_windows"], "max_abs_err": k6_err,
         "ms": res["k6_ms"], "device_ms": dev_ms["k6_ms"],
         "plain_ms": res["k6_plain_ms"],
         "bound_ms": k6_bms, "bound_by": k6_by, "library_ms": None},
        {"name": "segment_reduce_tiles", "route": "cuda", "source": src + "segment_reduce.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:2035",
         "launches": op_launches["segment_reduce_tiles"], "max_abs_err": k7_err,
         "ms": res["k7_ms"], "device_ms": dev_ms["k7_ms"],
         "plain_ms": res["k7_plain_ms"],
         "bound_ms": k7_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": res["k7_library_ms"]},
        {"name": "raster_bins_coverage", "route": "cuda", "source": src + "raster_bins.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:597",
         "launches": k8_launches["raster_bins_coverage"], "max_abs_err": k8_err,
         "ms": res["k8_ms"], "device_ms": dev_ms["k8_ms"],
         "plain_ms": res["k8_plain_ms"],
         "bound_ms": k8_bms, "bound_by": k8_by, "library_ms": None},
        {"name": "raster_fused_groups", "route": "cuda", "source": src + "raster_groups.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1505",
         "launches": sched_launches["raster_fused_groups"], "max_abs_err": k9_err,
         "ms": res["k9_tps8_ms"], "device_ms": dev_ms["k9_tps8_ms"],
         "plain_ms": res["k9_plain_ms"],
         "bound_ms": k1b_bms, "bound_by": k1b_by, "library_ms": None},
        {"name": "raster_fused_groups_local", "route": "cuda",
         "source": src + "raster_groups.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1442",
         "launches": sched_launches["raster_fused_groups_local"], "max_abs_err": k10_err,
         "ms": res["k10_ms"], "device_ms": dev_ms["k10_ms"],
         "plain_ms": res["k10_plain_ms"],
         "bound_ms": k10_bms, "bound_by": k10_by, "library_ms": None},
        {"name": "raster_chunkskip", "route": "cuda", "source": src + "raster_chunkskip.cu",
         "replaces": "smirk_tpu/render/rasterizer.py:1863",
         "launches": sched_launches["raster_chunkskip"], "max_abs_err": k11_err,
         "ms": res["k11_ch8_ms"], "device_ms": dev_ms["k11_ch8_ms"],
         "plain_ms": res["k11_plain_ms"],
         "bound_ms": k11_bounds[8][0], "bound_by": k11_bounds[8][1], "library_ms": None},
    ]}
    for k in line["kernels"]:
        assert all(isinstance(k[f], (int, float)) and math.isfinite(k[f])
                   for f in ("ms", "plain_ms", "bound_ms", "max_abs_err"))
    log(f"    worst tolerance ratios: K4 fold {k4f_ratio:.4g}, K4 store {k4_ratio:.4g}, "
        f"K5 (train shapes) {k5_ratio:.4g}, K5 (op path) {k5op_ratio:.4g}, gradient "
        f"{grad_ratio:.4g}, K7 {k7_ratio:.4g}, op-path gradient {op_grad_ratio:.4g} (of "
        f"1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-5, 1e-5 x scale; <= 1 passes)")
    log(f"    bounds: K4's fold {k4_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms (bytes, "
        f"{k4_bytes / 1e6:.2f} MB: the slots, g at {k4_live} of {slots3.numel()} pixels "
        f"with a live slot ({k4_live / slots3.numel() * 100:.1f} %), the bins of the "
        f"{k4_won} of {BT * Tp * cap} slots a live pixel reached "
        f"({k4_won / (BT * Tp * cap) * 100:.1f} %), the face table; every bin read "
        f"{k4_all_bins_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms); the per-slot route: K4's store "
        f"{k4_store_bytes / PEAK_HBM_BYTES * 1e3:.4f}"
        f" ms + K5 {k5_train_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms; K4's store "
        f"{res['k4_store_ms']:.4f} ms, K5 at these shapes {res['k5_train_ms']:.4f} ms, "
        f"the two {res['k4_store_then_k5_ms']:.4f} ms {card}")
    log(f"    bounds: K5 {k5_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms (bytes, "
        f"{k5_bytes / 1e6:.1f} MB: the bins, {k5_rows} of {b5op.numel()} rows of slots "
        f"that hold a face ({k5_rows / b5op.numel() * 100:.1f} %), the face table); every "
        f"row read {k5_all_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms ({k5_all_bytes / 1e6:.1f} MB)")
    k1c_kept, k1c_bins = k1_cycle["args"][:2]
    k1c_work = culled_work(k1c_kept, k1c_bins,
                           torch.stack(R._bbox_and_priority(k1_cycle["faces"][0], S)[:4], -1),
                           S)
    k1c_bms, k1c_by = culled_bound(k1c_work, k1c_kept.numel(), 5, 3)
    k1c_old_bms, _ = raster_bound(int(k1c_kept.sum()), k1c_kept.numel(), 5, 3,
                                  *k1c_kept.shape)
    log(f"    K1 through its custom op {res['k1_ms']:.4f} ms, its CUDA implementation "
        f"called directly {res['k1_direct_ms']:.4f} ms: the op's dispatch adds "
        f"{(res['k1_ms'] - res['k1_direct_ms']) * 1e3:.1f} us a call on the host {card}")
    log(f"    K1 at b{k1c_kept.shape[0]} on the cycle path's faces: "
        f"{res['k1_b32_cycle_ms']:.4f} ms, bound {k1c_bms:.4f} ms ({k1c_by}, "
        f"{k1c_work['box_pairs']} face-pixel pairs in the faces' boxes, "
        f"{k1c_work['binned_faces']} binned faces); every slot against every pixel "
        f"{k1c_old_bms:.4f} ms ({int(k1c_kept.sum())} chunk steps) {card}")
    for nm, w, bms, by, old_bms in (("K1", work1, k1_bms, k1_by, k1_old_bms),
                                    ("K1b", work1p, k1b_bms, k1b_by, k1b_old_bms)):
        log(f"    {nm} bound {bms:.4f} ms ({by}: {w['box_pairs']} face-pixel pairs in the "
            f"faces' boxes x {OPS_PER_FACE_PIXEL}, {w['binned_faces']} binned faces); "
            f"every slot against every pixel {old_bms:.4f} ms ({w['chunk_steps']} chunk "
            "steps x 32 x 1024 pixels); K9 takes K1b's bound and walk; "
            f"face-warp tests the cull keeps {kept_share(w)}")
    log(f"    bounds: K6 {k6_bms:.4f} ms ({k6_by}, {work6['box_pairs']} face-pixel pairs "
        f"in the faces' boxes x {OPS_PER_FACE_PIXEL}, {work6['binned_faces']} binned "
        f"faces; every slot against every pixel {k6_old_bms:.4f} ms, "
        f"{work6['chunk_steps']} chunk steps); K6's face-warp tests the cull keeps "
        f"{kept_share(work6)}")
    log(f"    bounds: K7 {k7_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms (bytes, "
        f"{k7_bytes / 1e6:.1f} MB: the slots, {k7_rows} payload rows of slots in [0, 512) "
        f"of {BT * Tp * R.TILE_PIX} ({k7_rows / (BT * Tp * R.TILE_PIX) * 100:.1f} %), the "
        f"output); every row read {k7_all_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms "
        f"({k7_all_bytes / 1e6:.1f} MB)")
    log(f"    bounds: K8 {k8_bms:.4f} ms ({k8_by}, {work8['box_pairs']} "
        f"face-pixel pairs in the faces' boxes x {OPS_PER_FACE_PIXEL_K8}; every binned "
        f"face against every pixel {k8_old_bms:.4f} ms, {k8_pairs} pairs); K8's "
        f"face-warp tests the cull keeps {kept_share(work8)}")
    for nm, w, bms, by, old_bms in (("K3", work3, k3_bms, k3_by, k3_old_bms),
                                    ("K3b", work3p, k3b_bms, k3b_by, k3b_old_bms)):
        log(f"    {nm} bound {bms:.4f} ms ({by}: {w['box_pairs']} face-pixel pairs "
            f"in the faces' boxes x {OPS_PER_FACE_PIXEL}, {w['binned_faces']} binned faces); "
            f"the unculled count's bound {old_bms:.4f} ms ({w['chunk_steps']} chunk steps x "
            f"32 x 1024 pixels); face-warp tests the cull keeps {kept_share(w)}")
    log(f"    K10 bound {k10_bms:.4f} ms ({k10_by}); face-warp tests its cull (the "
        f"rebase's 128u boxes) keeps {kept_share(work10)}")
    for ch, w in work11.items():
        log(f"    K11 chunk {ch} bound {k11_bounds[ch][0]:.4f} ms ({k11_bounds[ch][1]}: "
            f"{w['box_pairs']} face-pixel pairs in the faces' boxes x {OPS_PER_FACE_PIXEL}, "
            f"{w['binned_faces']} records of the binned chunks); every slot against every "
            f"pixel {raster_bound(w['chunk_steps'], n_tiles, 5, 3, B, Tp)[0]:.4f} ms "
            f"({w['chunk_steps']} steps of 32 faces); face-warp tests the cull keeps "
            f"{kept_share(w)}; "
            f"{res[f'k11_ch{ch}_ms']:.4f} [{dev_ms[f'k11_ch{ch}_ms']:.4f}] ms {card}")
    log(f"    the plain schedules past the function's work: the group walk of K9 and "
        f"K10 {int((e9 - s9).sum())} and {int((e10 - s10).sum())} chunk steps at tps 8, "
        f"against K1b's {win_p}; K9 at tps 16 {res['k9_tps16_ms']:.4f} "
        f"[{dev_ms['k9_tps16_ms']:.4f}] ms {card}")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
