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
    (no YAML file), b32, one epoch of 4 steps, a checkpoint every 2 steps,
    8 loader workers, no image panels, the port's `assets.load_all` patched to the recentred
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
 5l. the native host ops (after 5k; the library built at first use, with
    g++, before 5f, whose loader workers only load it): one loader sample's
    host work at 224 px on 16 seeded 320 px frames of the synthetic
    dataset, split into the crop warp, the hull fill, CLAHE + the
    augment's shift-scale-rotate warps and the MICA warp, each through the
    numpy oracles and through the library by direct calls; the library
    within one 8-bit level of the oracles (the nearest warp and the hull
    exactly); `prepare_sample`'s time and the 8 workers' rate it implies
    beside 5f's loader;
 5m. data parallel at Config()'s full width, b32, both parities, fp32,
    every compared step with the discrete parts (hints, holes, the cycle
    render) of one recording step: (a) NCCL at world size 1 against the
    no-group step (the losses bitwise, the parameters after two steps
    within Adam's sign flips, each gradient tensor and statistic at the
    CPU test's tolerances or a rerun's difference); (b) two gloo ranks on
    the one card (children of this script, `--dp-rank`), 16 rows each,
    against the one-process b32 step, each gradient tensor at the CPU
    test's tolerance or eight times the one-process step's own change
    under a rerun, autotuned algorithms and batch norm's statistics as
    the ranks combine them, the ranks bitwise equal; the steps timed
    alternately with and without the group; each step's ms and its
    collectives' share (replayed alone). No run spans two cards;
 5n. the binning and fold modes (after 5m), on infer's faces (b64, 224 px,
    the face region, capacity 384): flat binning at approx 0.95, hier
    (exact and at 0.95) and sorted binning give bins and counts bitwise
    equal to exact flat binning (sorted on the images without a span clip,
    whose count is printed), with no selection misses;
    `SmirkSystem.infer` under the default, hier and sorted modes, each
    mode a capture of its own (the dispatch reaching it in the warm-up and
    the capture) then a replay, bitwise equal, K1 launched once a call; one
    b32 train step (p0, learning rate 0, fresh systems of one seed) under
    sorted and flat binning with bitwise equal losses, K3 and K4's fold
    launched; the "scatter", "sorted_scatter" and "cumsum" fold modes on
    K4's store rows (the training backward) and on K7's rows (the op
    path's) within 1e-5 x the sum of magnitudes of K4's fold epilogue and
    of K5, neither launched; at b4 the gradients of both backwards
    end to end under each mode (rasterize_planes_diff: K4's store and
    the mode's fold, K4's fold epilogue under "matmul"; rasterize at
    D = 9: K7, then the mode's fold, K5 under "matmul") within 1e-4 x
    `dense_gradient_and_scale`'s rounding scale of "matmul"'s; CUDA-event medians of 5 of
    each binning function at b64, each fold mode, and `infer` with the
    miss check armed and disarmed, alternating; the modes restored
    however the phase ends;
 5o. the reference's shape, batch 1 (after 5n): (a) `Predictor.__call__`
    on 20 seeded 480x640 frames through the landmark crop (the main path's
    landmarks_mp mapped into each frame as in 5e), one frame a call on the
    card: every output finite, no overflow, K1 launched once a call, each
    frame against its row of b8 calls on the same frames (parameters,
    vertices and landmarks within 1e-4; pix_to_face on >= 99.5 % of each
    frame's pixels; the render within 1e-4 where pix_to_face agrees, each
    pixel past it printed with its face's area before the phase fails;
    the row's vertices rendered alone bitwise equal to the row's render,
    so the render does not depend on the batch), the p50 /
    p90 ms a frame (host preparation, the crop and the copy back included)
    and every call's; (b) `cli.demo.main` on one seeded PNG with its landmark
    .npy, --crop, without and with --use_smirk_generator --render_orig, no
    --device: the panel written in the JAX CLI's shape ((224, 448, 3) and
    (480, 1920, 3)), finite, K1 launched once; (c) `cli.demo_video.main` on
    16 seeded frames with a landmark track, --crop, at --batch 1 and 8,
    without and with the generator, no --device: 16 panels written each
    time, K1 once a chunk, each frame's outputs at --batch 1 against
    --batch 8 under (a)'s rule, each run's ms a frame by the demo's own
    clock and by the whole run's. PIL, which reads and writes the demos'
    files, must be installed (a gate);
 5p. the pretrain recipe: `cli.train.main` on configs/config_pretrain.yaml
    --synthetic at b32, 4 steps, 8 loader workers, in this process, with
    SMIRK_MICA at a seeded full-depth mica.tar (5k's writer) and the port's
    `assets.load_all` patched to the recentred head: every metrics.jsonl
    record finite, landmark_loss_fan, landmark_loss_mp and mica_loss
    nonzero at every step, no generator, no loss_second_path and no cycle
    metric, no raster overflow, K1 once a step and neither K3 nor K4's fold,
    all three sub-encoders moved between the first and the last step; one
    b32 `_loss1` and its gradient: K1's render reaches no gradient (the
    landmarks do) and no warning comes from K1's op or the port; then
    `SmirkSystem.train_step` under the recipe at lr 0, the median of 5
    after 2 warm steps on the host clock (each ended by a synchronize),
    every run printed beside [6]'s fp32 p0 step;
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
    of infer (and K3 with its inputs, the training raster's forward), a
    torch.profiler trace of one train step per parity
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
    K1's launches those of the main path, of the reconstruct call, of
    the served calls of 5i, of 5j's and 5k's steps and of 5o's and 5p's
    calls, its `direct_ms` the launch without the custom op's dispatch;
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
    lmks, lmk_scale = frame_landmarks(out["landmarks_mp"][..., :2], S)
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
    width (the recipe's values as dotted overrides, no YAML file),
    --synthetic, b32, 4 steps, 8 loader workers (a
    loader starts no more workers than its epoch has batches), the port's
    `assets.load_all` patched to the recentred procedural head, and one
    direct `make_visualizations` (its grid, not written to a file) -> {"loader_images_s", "cli_steps_s", "launches"} (K1, K3 and
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
    `SmirkSystem.infer` equals (bitwise) a call with them False, its graph
    captured under them; its body with the pin bypassed runs TF32 and
    differs by more; the globals read True after the pinned call."""
    import torch

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
        system.infer_graphs.graphs.clear()  # so that this call captures: warm-up, capture
        on = system.infer(img)
        check(seen == [(False, False)] * 2,
              f"inside the pinned call both flags read False ({seen})")
        check((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
              == (True, True), "the globals read True after the pinned call")
        with torch.inference_mode():
            unpinned = system.infer_body(img)  # fp32_math bypassed
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
        files = {"vgg16.pth": vgg_sd, "emotion.ckpt": {"state_dict": emo},
                 "mica.tar": _mica_tar(gen)}
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


# the native host ops (phase 5l): the samples of the per-sample split, the
# seeded 320 px frames of the synthetic dataset ([5f]'s)
NATIVE_SAMPLES = 16
# data parallel (phase 5m): the ranks of the gloo run on the one card and
# the seconds its children may take; the steps a timing discards and the
# steps it times (their median); the tolerances of the CPU test
# (tests/test_torch_parallel.py): metrics 1e-4 x max(1, |ref|), each summed
# gradient 1e-4 of its tensor's max magnitude or of a share of its call's
# largest entry, whichever is more (the CPU test's share 1 %, here 10 %:
# at 224 px and b32 a rank's split of path 1's reductions moves a small
# encoder tensor by 5e-6 of its call's largest entry), the running
# statistics 1e-5 (here of max(1, their magnitude)); the share of a
# process's own discrete-part pixels that may differ from the held ones'
# by more than DP_FLIP_ATOL
DP_WORLD, DP_TIMEOUT_S = 2, 600
DP_WARM_STEPS, DP_TIMED_STEPS = 2, 5
DP_METRIC_RTOL, DP_GRAD_RTOL, DP_GRAD_FLOOR, DP_STATS_RTOL = 1e-4, 1e-4, 1e-1, 1e-5
# (b)'s floor: this many times the one-process step's largest change of a
# gradient tensor under exact changes of its arithmetic (none of them
# reorders every batch reduction as the ranks' split does: a rank's
# difference has reached 4 times that change at one tensor of 702)
DP_FLOOR_K = 8
DP_FLIP_ATOL, DP_FLIP_SHARE = 1e-3, 1e-3


def recentred_head():
    """The main path's head: procedural_bundle(seed=0, full_size=True) with
    the face region recentred onto the optical axis (bench.py's cam_fix:
    random-init weights leave cam = [7, 0, 0]; here in the template, the
    same translation before the cam scale)."""
    import numpy as np

    from smirk_tpu_torch.assets import procedural_bundle

    bundle = procedural_bundle(seed=0, full_size=True)
    vt = np.array(bundle["v_template"], np.float32)
    centre = vt[np.asarray(bundle["face_vertex_ids"])].mean(0)
    vt[:, :2] -= centre[:2]
    bundle["v_template"] = vt
    return bundle


def _host_ms(fn, n=3):
    """(fn's result, its least host ms over n calls)."""
    best, out = float("inf"), None
    for _ in range(n):
        t = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t) * 1e3)
    return out, best


def native_phase(build, loader_ips, train_ms, card):
    """Phase 5l: the native host-ops library (`smirk_tpu_torch.native`) on
    one loader sample's host work, on NATIVE_SAMPLES of the synthetic
    dataset's seeded 320 px frames at 224 px: the crop warp, the hull fill,
    CLAHE + the augment's shift-scale-rotate warps (bilinear image, nearest
    mask) and the MICA warp, each timed through the numpy oracles and
    through the library by direct calls (the least of 3 calls, host
    clock), the library held to the oracles (the warps and CLAHE within
    one 8-bit level, the nearest warp and the hull exactly); then a whole
    `prepare_sample` (the training draws) on the library, and the 8
    workers' rate it implies beside [5f]'s loader (8 spawned workers, the
    library) -> {"build_s", "numpy_ms", "library_ms", "prepare_ms"}."""
    import numpy as np

    from smirk_tpu_torch.data import datasets as D
    from smirk_tpu_torch.data import transforms as T
    from smirk_tpu_torch.data.base import prepare_sample

    t_phase = time.perf_counter()
    log(f"[5l] native host ops: libfastops (g++) against the numpy oracles on "
        f"{NATIVE_SAMPLES} seeded 320 px frames, one loader sample's host work at 224 px")
    if build:
        log(f"    built libfastops at first use (g++ -O3 -march=native -ffp-contract=off) "
            f"in {build['seconds']:.2f} s")
    config = _variant()
    S = config.image_size
    ds = D.SyntheticFaceDataset(config, length=2 * NATIVE_SAMPLES)
    ds._prepare = lambda rng, img, fan, mp: (img, fan, mp)  # the raw frame
    # the frames with FAN landmarks (every fifth has none: no MICA warp)
    frames = [f for f in map(lambda i: ds._get(i, None), range(2 * NATIVE_SAMPLES))
              if f[1] is not None][:NATIVE_SAMPLES]
    parts = ("warp", "hull", "clahe_augment", "mica")
    ms = {k: [[], []] for k in parts}  # part -> [numpy ms, library ms] per sample
    worst = {"warp": 0.0, "ssr": 0.0, "clahe": 0.0, "mica": 0.0}
    exact = {"hull": True, "nearest": True}
    th = np.deg2rad(7.0)
    R = 1.05 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    M_ssr = np.eye(3)
    M_ssr[:2, :2] = R
    M_ssr[:2, 2] = np.array([S / 2, S / 2]) - R @ np.array([S / 2, S / 2]) + [5.0, -4.0]
    for img, fan, mp in frames:
        f32 = np.asarray(img, np.float32)
        mp = np.asarray(mp, np.float32)
        M = T.crop_face_tform(mp, 1.6, S)
        a, t_np = _host_ms(lambda: T.warp_affine_np(f32, M, (S, S)))
        b, t_lib = _host_ms(lambda: T.warp_affine_host(f32, M, (S, S)))
        ms["warp"][0].append(t_np)
        ms["warp"][1].append(t_lib)
        worst["warp"] = max(worst["warp"], float(np.abs(a - b).max()))  # 0-255 scale
        lmk = T.transform_points(M, mp)
        h_np, t_np = _host_ms(lambda: T.convex_hull_mask_np(lmk, (S, S)))
        h_lib, t_lib = _host_ms(lambda: T.convex_hull_mask_host(lmk, (S, S)))
        ms["hull"][0].append(t_np)
        ms["hull"][1].append(t_lib)
        exact["hull"] &= bool(np.array_equal(h_np, h_lib))
        im01 = (np.clip(b, 0, 255) / 255.0).astype(np.float32)
        face = (1.0 - h_lib)[..., None]

        def clahe_ssr(clahe, warp, nearest):
            c = clahe(im01, 2.5)
            return c, warp(c, M_ssr, (S, S)), nearest(face, M_ssr, (S, S))

        (c1, _, m1), t_np = _host_ms(lambda: clahe_ssr(
            T._clahe_np, T.warp_affine_np, T._warp_affine_nearest_np))
        (c2, w2, m2), t_lib = _host_ms(lambda: clahe_ssr(
            T._clahe, T.warp_affine_host,
            lambda x, m, s: T.warp_affine_host(x, m, s, order=0)))
        ms["clahe_augment"][0].append(t_np)
        ms["clahe_augment"][1].append(t_lib)
        worst["clahe"] = max(worst["clahe"], float(np.abs(c1 - c2).max()) * 255)
        worst["ssr"] = max(worst["ssr"], float(np.abs(T.warp_affine_np(c2, M_ssr, (S, S))
                                                      - w2).max()) * 255)
        exact["nearest"] &= bool(np.array_equal(m1, m2))
        Ma = T.arcface_tform(np.asarray(fan, np.float32), 112)
        src = f32 / 255.0
        a, t_np = _host_ms(lambda: T.warp_affine_np(src, Ma, (112, 112)))
        b, t_lib = _host_ms(lambda: T.warp_affine_host(src, Ma, (112, 112)))
        ms["mica"][0].append(t_np)
        ms["mica"][1].append(t_lib)
        worst["mica"] = max(worst["mica"], float(np.abs(a - b).max()) * 255)
    check(all(v <= 1.0 for v in worst.values()),
          "the library's warps (crop, shift-scale-rotate, MICA) and CLAHE within one 8-bit "
          f"level of the numpy oracles ({', '.join(f'{k} {v:.4g}' for k, v in worst.items())}"
          " levels)")
    check(exact["hull"] and exact["nearest"],
          "the library's hull fill and nearest warp equal to the oracles, exactly")
    med = {k: [statistics.median(v[0]), statistics.median(v[1])] for k, v in ms.items()}
    for k in parts:
        log(f"    {k}: numpy {med[k][0]:.3f} ms, library {med[k][1]:.3f} ms "
            f"(x{med[k][0] / max(med[k][1], 1e-9):.1f}; median over samples)")
    tot = [sum(med[k][i] for k in parts) for i in (0, 1)]
    log(f"    the four: numpy {tot[0]:.3f} ms, library {tot[1]:.3f} ms a sample (host clock)")
    prep = []
    for i, (img, fan, mp) in enumerate(frames):
        _, t = _host_ms(lambda: prepare_sample(np.random.default_rng(i), img, fan, mp, S,
                                               [1.2, 1.8]), n=1)
        prep.append(t)
    prep_ms = statistics.median(prep)
    log(f"    prepare_sample (training draws, the library): median {prep_ms:.3f} ms a "
        f"sample -> {8 * 1e3 / prep_ms:.1f} images/s over 8 workers at one sample each; "
        f"with the numpy oracles it would add {tot[0] - tot[1]:.3f} ms "
        f"({8 * 1e3 / (prep_ms + tot[0] - tot[1]):.1f} images/s); [5f]'s loader (8 spawned "
        f"workers, the library) {loader_ips:.1f} images/s; a b{TRAIN_B} step needs "
        f"{TRAIN_B / (train_ms[0] / 1e3):.1f} (p0) / {TRAIN_B / (train_ms[1] / 1e3):.1f} "
        f"(p1) at [6]'s fp32 times {card}")
    log(f"    [5l] took {time.perf_counter() - t_phase:.1f} s")
    return {"build_s": build.get("seconds") if build else None, "numpy_ms": med,
            "library_ms_total": tot[1], "numpy_ms_total": tot[0], "prepare_ms": prep_ms}


def _replay_ms(ops, device="cuda") -> float:
    """Host ms of the recorded collectives (`parallel.record`) issued alone,
    on fresh buffers on `device`, in the step's order (every rank replays
    the same)."""
    import torch

    from smirk_tpu_torch.parallel import mesh

    bufs = [(name, torch.zeros(n, dtype=dt, device=device)) for name, n, dt in ops]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for name, buf in bufs:
        if name == "all_reduce":
            mesh._all_reduce_(buf)
        elif name == "all_gather":
            mesh.all_gather_rows({"x": buf[None]})
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


class _Held:
    """The discrete parts of one compared step of phase 5m, in the order
    the step makes them (the masked images of both paths, the cycle path's
    render of the augmented parameters): recorded on the host (`given`
    None) or replaced by this process's rows of the recorded ones
    (`parallel.local_rows` of the b32 step's), the share of this process's
    own pixels that differ by more than DP_FLIP_ATOL noted."""

    def __init__(self, given=None):
        self.given, self.taken, self.flips = given, [], []

    def __call__(self, x):
        from smirk_tpu_torch import parallel

        if self.given is None:
            self.taken.append(x.detach().cpu())
            return x
        ref = self.given[len(self.taken)].to(x.device)
        ref = parallel.local_rows(ref, ref.shape[0] // TRAIN_B)
        self.taken.append(None)
        self.flips.append(float(((x - ref).abs().amax(-1) > DP_FLIP_ATOL).float().mean()))
        return ref


class _HeldRenderer:
    """A system's renderer with its inference render's image held."""

    def __init__(self, renderer, held):
        self.renderer, self.held = renderer, held

    def __call__(self, *a, **k):
        out = self.renderer(*a, **k)
        if k.get("inference"):
            out = dict(out, rendered_img=self.held(out["rendered_img"]))
        return out

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def _ranks_batch_norm(batch_norm, world):
    """F.batch_norm whose train-mode statistics are those of its rows as
    `world` ranks of b32 hold them (groups x world x b rows, as
    `parallel.local_rows` splits them): each part's two-pass moments,
    combined by the parallel-variance formula."""
    import torch

    def norm(x, running_mean, running_var, weight, bias, training, momentum, eps):
        if not training:
            return batch_norm(x, running_mean, running_var, weight, bias, training,
                              momentum, eps)
        parts = x.reshape((-1, world, TRAIN_B // world) + tuple(x.shape[1:])).transpose(0, 1)
        var, mean = torch.var_mean(parts, dim=(1, 2, 4, 5), unbiased=False)
        g_mean = mean.mean(0)
        g_var = (var + (mean - g_mean) ** 2).mean(0)
        scale = torch.rsqrt(g_var + eps) * weight
        return (x - g_mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]

    return norm


def _dp_system(bundle, img, cycle_in, **flags):
    """A full-width system of phase 5m whose batch-norm running statistics
    are those of its step's inputs (one train-mode forward at momentum 0
    on this process's rows: the encoder's on `img`, the generator's on the
    cycle path's input `cycle_in`), so that the cycle path's eval-mode
    applies are normalized as a trained model's are."""
    import torch

    from smirk_tpu_torch.models import mobilenetv3 as mnv3
    from smirk_tpu_torch.train.trainer import SmirkSystem

    system = SmirkSystem(_variant(**flags), bundle)
    momentum, mnv3.BN_MOMENTUM = mnv3.BN_MOMENTUM, 0.0
    try:
        with torch.no_grad():
            system.encoder.train()(img.to(system.device))
            system.generator.train()(cycle_in.to(system.device))
    finally:
        mnv3.BN_MOMENTUM = momentum
    system.base_encoder.load_state_dict(system.encoder.state_dict())
    return system


def _dp_compared_step(system, batch, parity, held, calls):
    """One train_step of `system` at `parity` with its discrete parts held
    (`_Held`) and the summed gradients of every `_grads` call appended to
    `calls` -> its metrics."""
    from smirk_tpu_torch.masking import masking
    from smirk_tpu_torch.train.trainer import SmirkSystem

    grads_fn, compose = SmirkSystem._grads, masking.compose_mask
    grads_attr = SmirkSystem.__dict__["_grads"]  # the staticmethod, to restore

    def kept(total, params):
        g = grads_fn(total, params)
        calls.append([x.detach().cpu() for x in g])
        return g

    SmirkSystem._grads = staticmethod(kept)
    masking.compose_mask = lambda *a, **k: held(compose(*a, **k))
    renderer, system.renderer = system.renderer, _HeldRenderer(system.renderer, held)
    try:
        return system.train_step(batch, parity)[0]
    finally:
        SmirkSystem._grads, masking.compose_mask = grads_attr, compose
        system.renderer = renderer


def dp_held(bundle, batch) -> dict:
    """The discrete parts of phase 5m's compared steps: for each parity a
    fresh full-width system at learning rate 0 (its generator's statistics
    those of [img, img]; the parts do not read the generator) takes one
    no-group step, its parts recorded -> {"p0": [...], "p1": [...]}."""
    import torch

    out = {}
    for parity in (0, 1):
        system = _dp_system(bundle, batch["img"], torch.cat([batch["img"]] * 2, -1), lr=0.0)
        held = _Held()
        _dp_compared_step(system, batch, parity, held, [])
        out[f"p{parity}"] = held.taken
        del system
    return out


def dp_steps(bundle, batch, given, ranks_norm=False, warm=DP_WARM_STEPS,
             timed=DP_TIMED_STEPS) -> dict:
    """Phase 5m's steps in this process (no group, NCCL world 1 or a gloo
    rank), on `batch` (this process's rows): for each parity a fresh
    full-width system (`_dp_system`, its generator's statistics those of
    the held cycle input) at learning rate 0 takes one step with its
    discrete parts replaced by this process's rows of `given`'s
    (`dp_held`; its metrics, the summed gradients of every `_grads` call,
    the batch-norm running statistics, the differing pixel shares), with
    `ranks_norm` its train-mode batch norm normalizing by the statistics
    of its rows as DP_WORLD ranks hold them; then `warm` steps untimed and
    `timed` more, each timed (host clock, the card synchronized), the last
    one's collectives recorded and then replayed alone; then one system at
    the recipe's rate takes p0 then p1 (their metrics and the parameters
    after)."""
    import torch
    import torch.nn.functional as F

    from smirk_tpu_torch import parallel
    from smirk_tpu_torch.train.trainer import SmirkSystem

    batch_norm = F.batch_norm
    out = {}
    try:
        for parity in (0, 1):
            parts = given[f"p{parity}"]
            cycle_in = torch.cat(parts[-2:], -1)  # the cycle path's render and mask
            if ranks_norm:
                F.batch_norm = _ranks_batch_norm(batch_norm, DP_WORLD)
            system = _dp_system(bundle, batch["img"], parallel.local_rows(
                cycle_in, cycle_in.shape[0] // TRAIN_B), lr=0.0)
            held, calls = _Held(parts), []
            metrics = _dp_compared_step(system, batch, parity, held, calls)
            F.batch_norm = batch_norm
            name = {id(t): f"{m}.{n}" for m in ("encoder", "generator")
                    for n, t in getattr(system, m).named_parameters()}
            enc = [name[id(t)] for t in system.enc_params]
            gen = [name[id(t)] for t in system.gen_params]
            res = {"metrics": metrics, "grads": calls, "flips": held.flips,
                   "names": [enc + gen if len(c) == len(enc) + len(gen)
                             else enc if len(c) == len(enc) else gen for c in calls],
                   "stats": {f"{m}.{k}": v.detach().cpu().clone()
                             for m in ("encoder", "generator")
                             for k, v in getattr(system, m).state_dict().items()
                             if "running" in k}}
            ms = []
            for i in range(warm + timed):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with parallel.record() as ops:
                    system.train_step(batch, parity)
                torch.cuda.synchronize()
                if i >= warm:
                    ms.append((time.perf_counter() - t) * 1e3)
            res["ms"] = statistics.median(ms)
            res["ms_all"] = ms
            res["collective_ms"] = _replay_ms(ops)
            res["collectives"] = len(ops)
            res["collective_bytes"] = sum(n * torch.empty((), dtype=dt).element_size()
                                          for _, n, dt in ops)
            out[f"p{parity}"] = res
            del system
        system = SmirkSystem(_variant(), bundle)
        out["step"] = {"metrics": [system.train_step(batch, p)[0] for p in (0, 1)],
                       "params": [p.detach().cpu() for p in system.enc_params
                                  + system.gen_params]}
        del system
    finally:
        F.batch_norm = batch_norm
    return out


def _fmt(d: dict) -> str:
    return "{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items()) + "}"


def dp_floor(k, ref, *alts) -> dict:
    """Per parity, `_grads` call and tensor, k times the largest difference
    of the `alts`' summed gradients to `ref`'s: the one-process step's own
    float32 spread under exact changes of its arithmetic."""
    return {p: [[k * max(float((a[p]["grads"][c][i] - y).abs().max()) for a in alts)
                 for i, y in enumerate(rc)] for c, rc in enumerate(ref[p]["grads"])]
            for p in ("p0", "p1")}


def dp_floor_share(ref, floor) -> tuple:
    """(the tensors whose floor is over DP_GRAD_RTOL of their scale, all
    the tensors, the median floor over its scale, the largest and where)."""
    over, n, most, shares = 0, 0, (0.0, None), []
    for p in ("p0", "p1"):
        for c, rc in enumerate(ref[p]["grads"]):
            top = max(float(y.abs().max()) for y in rc)
            for i, y in enumerate(rc):
                scale = max(float(y.abs().max()), DP_GRAD_FLOOR * top)
                f = floor[p][c][i] / scale
                shares.append(f)
                n += 1
                over += f > DP_GRAD_RTOL
                if f > most[0]:
                    most = (f, (p, c, ref[p]["names"][c][i]))
    return over, n, statistics.median(shares), most


def dp_compare(got, ref, floor=None) -> dict:
    """Worst ratios to phase 5m's tolerances (<= 1 passes) of `got`'s
    learning-rate-0 steps against `ref`'s: "metrics" (DP_METRIC_RTOL x
    max(1, |loss|)), "grads" (each summed gradient tensor within
    DP_GRAD_RTOL of its max magnitude, or of DP_GRAD_FLOOR of its call's
    largest entry where that is more: the rounding of a backward is of the
    call's scale, and a tensor whose exact gradient is 0 holds rounding
    alone; or within `floor`'s entry, the step's own rerun difference,
    where that is more), "stats" (each running statistic within
    DP_STATS_RTOL x max(1, its max magnitude)); with where each worst one
    is (`at`)."""
    worst = {"metrics": 0.0, "grads": 0.0, "stats": 0.0}
    at = {}

    def note(kind, ratio, where):
        if ratio > worst[kind] or kind not in at:
            worst[kind], at[kind] = max(ratio, worst[kind]), where

    for p in ("p0", "p1"):
        g, r = got[p], ref[p]
        for k, want in r["metrics"].items():
            d = abs(g["metrics"][k] - want)
            note("metrics", d / (DP_METRIC_RTOL * max(1.0, abs(want))), (p, k, d, want))
        for c, (gc, rc) in enumerate(zip(g["grads"], r["grads"])):
            top = max(float(y.abs().max()) for y in rc)
            for i, (x, y, nm) in enumerate(zip(gc, rc, r["names"][c])):
                d, m = float((x - y).abs().max()), float(y.abs().max())
                fl = floor[p][c][i] if floor is not None else 0.0
                note("grads", d / max(DP_GRAD_RTOL * max(m, DP_GRAD_FLOOR * top), fl),
                     (p, c, nm, d, m, top, fl))
        for k, y in r["stats"].items():
            d, m = float((g["stats"][k] - y).abs().max()), float(y.abs().max())
            note("stats", d / (DP_STATS_RTOL * max(1.0, m)), (p, k, d, m))
    return {**worst, "at": at}


def _params_sha(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in params:
        h.update(p.numpy().tobytes())
    return h.hexdigest()


def _dp_batch():
    import torch

    from smirk_tpu_torch.bench import train_batch

    return {k: torch.from_numpy(v)
            for k, v in train_batch(TRAIN_B, _variant().image_size, 0).items()}


def dp_rank_main(args) -> int:
    """A gloo rank of phase 5m (a child of this script): its rows of the
    b32 batch through `dp_steps`, with the discrete parts the parent
    recorded, compared with the reference the parent wrote -> rank<r>.json
    in --dp-dir."""
    import os

    import torch
    import torch.distributed as dist

    from smirk_tpu_torch import parallel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.dp_port}",
                            rank=args.dp_rank, world_size=args.dp_world)
    try:
        ref = torch.load(os.path.join(args.dp_dir, "ref.pt"), weights_only=False)
        res = dp_steps(recentred_head(), parallel.shard_batch(_dp_batch()), ref["held"],
                       warm=1, timed=3)
        summary = {"worst": dp_compare(res, ref["a1"], ref["floor"]),
                   "worst_no_floor": dp_compare(res, ref["a1"]),
                   "flips": {p: res[p]["flips"] for p in ("p0", "p1")},
                   "step_metrics": res["step"]["metrics"],
                   "params_sha": _params_sha(res["step"]["params"]),
                   "stats_sha": _params_sha([v for p in ("p0", "p1")
                                             for v in res[p]["stats"].values()]),
                   **{f"{k}_{p}": res[p][k] for p in ("p0", "p1")
                      for k in ("ms", "collective_ms", "collectives", "collective_bytes")}}
        with open(os.path.join(args.dp_dir, f"rank{args.dp_rank}.json"), "w") as f:
            json.dump(summary, f)
    finally:
        parallel.shutdown()
    return 0


def dp_phase(bundle, train_ms, card) -> dict:
    """Phase 5m: data parallel (`smirk_tpu_torch.parallel`) at Config()'s
    full width, b32, both parities, fp32, cuDNN's deterministic
    algorithms. One no-group step a parity records the discrete parts (the
    masked images' hints and holes, the cycle path's render of the
    augmented parameters: a last-bit change of a vertex can flip one of
    their pixels); every compared step takes them, after its own are
    checked against them, on fresh systems whose running statistics are
    those of the step's inputs (`_dp_system`).
    (a) NCCL at world size 1 on the card against the no-group step: at
    learning rate 0 every loss bitwise where a no-group rerun's is; each
    gradient tensor within 1e-4 of its scale (its max magnitude, at least
    DP_GRAD_FLOOR of its call's largest entry) or twice a no-group rerun's
    difference (K4's fold sums with atomics), each statistic within 1e-5
    of max(1, its magnitude); the parameters after p0 + p1 at the recipe's
    rate bitwise where two no-group runs are, else within the sign flips
    of near-zero gradients (Adam moves a parameter by ~lr x sign(g)); the
    steps timed no group, NCCL, no group, NCCL.
    (b) two gloo ranks on the one card (children of this script), 16 rows
    each, against the one-process b32 step: every loss within 1e-4 x
    max(1, |loss|), each statistic as (a), each gradient tensor within
    1e-4 of its scale or DP_FLOOR_K times the one-process step's own
    largest change under a rerun, cuDNN's autotuned algorithms and batch
    norm's statistics as the ranks combine them (the cycle path's float32
    gradients move by up to tens of percent of a tensor under those exact
    changes, so no bound of 1e-4 holds there; the CPU test holds the
    ranks without a floor); the ranks' own discrete parts within
    DP_FLIP_SHARE of the held pixels, their parameters bitwise equal to
    each other; each step's ms and the share of its collectives (replayed
    alone). NCCL refuses two ranks on one card, so no run here spans two
    cards."""
    import os
    import shutil
    import socket
    import tempfile

    import torch

    from smirk_tpu_torch import parallel

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def nccl_steps(given):
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
               "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
        os.environ.update(env)
        try:
            check(parallel.initialize_distributed() == 1 and torch.distributed.get_backend()
                  == "nccl", "NCCL group of world size 1 initialized")
            return dp_steps(bundle, batch, given=given)
        finally:
            parallel.shutdown()
            for k in env:
                del os.environ[k]

    t_phase = time.perf_counter()
    log(f"[5m] data parallel: train_step at b{TRAIN_B}, 224 px, fp32, both parities; "
        f"(a) NCCL world 1, (b) {DP_WORLD} gloo ranks on the one card")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="smirk_dp_")
    try:
        batch = _dp_batch()
        # the discrete parts of every compared step; then no group, NCCL, no
        # group, NCCL
        held = dp_held(bundle, batch)
        a1 = dp_steps(bundle, batch, held)
        b1 = nccl_steps(held)
        a2 = dp_steps(bundle, batch, held)
        b2 = nccl_steps(held)
        floor = dp_floor(2, a1, a2)
        for name, x in (("no group", a1), ("NCCL world 1", b1), ("no group rerun", a2),
                        ("NCCL world 1 rerun", b2)):
            flips = [f for p in ("p0", "p1") for f in x[p]["flips"]]
            check(all(f <= DP_FLIP_SHARE for f in flips),
                  f"(a) {name}: its own discrete parts within {DP_FLIP_SHARE:g} of the held "
                  f"ones' pixels (differing shares {flips})")

        # at learning rate 0 the losses of a step are its forward's: bitwise
        # equal with and without the group where a rerun's are (the forward's
        # vertex normals sum with index_add_'s atomics), else within the
        # tolerance of (b) (checked with the gradients and statistics below)
        for p in ("p0", "p1"):
            if a1[p]["metrics"] == a2[p]["metrics"]:
                check(b1[p]["metrics"] == a1[p]["metrics"],
                      f"(a) NCCL world 1, {p} at lr 0: every loss bitwise equal to the "
                      "no-group step's (a rerun's are too)")
            else:
                log(f"    (a) {p} at lr 0: a no-group rerun's losses differ (worst "
                    f"{max(abs(a2[p]['metrics'][k] - v) for k, v in a1[p]['metrics'].items()):.3g}"
                    f"), NCCL world 1's by {max(abs(b1[p]['metrics'][k] - v) for k, v in a1[p]['metrics'].items()):.3g}")

        def params_gap(x, y):
            return max(float((u - v).abs().max())
                       for u, v in zip(x["step"]["params"], y["step"]["params"]))

        rerun, with_group = params_gap(a2, a1), params_gap(b1, a1)
        lr = _variant().train.lr
        if rerun == 0.0:
            check(with_group == 0.0, "(a) NCCL world 1: the parameters after p0 + p1 at the "
                  "recipe's rate bitwise equal to the no-group steps' (a rerun's are too)")
        else:
            # a rerun's gradients differ in the last bits, and Adam's first
            # steps move a parameter by ~lr x sign(g): a near-zero gradient
            # whose sign flips moves it by up to 2 lr a step
            check(with_group <= 4 * lr,
                  f"(a) NCCL world 1: the parameters after p0 + p1 within the sign flips of "
                  f"near-zero gradients, 2 lr a step ({with_group:.3g} <= {4 * lr:.3g}; a "
                  f"no-group rerun {rerun:.3g}: the no-group step is not bitwise "
                  "reproducible, K4's fold sums with atomics)")
        log("    (a) losses after p0 + p1 at the recipe's rate: " + ", ".join(
            f"{k} {x[k]:.6g} / {y[k]:.6g} / {z[k]:.6g}"
            for k in ("loss_first_path", "loss_second_path")
            for x, y, z in [(a1["step"]["metrics"][1], a2["step"]["metrics"][1],
                             b1["step"]["metrics"][1])]) + " (no group, rerun, NCCL world 1)")
        wa2, wa = dp_compare(a2, a1), dp_compare(b1, a1, floor)
        log(f"    (a) a no-group rerun against the first, worst ratios without the rerun "
            f"floor {wa2}")
        check(all(wa[k] <= 1.0 for k in ("metrics", "grads", "stats")),
              f"(a) NCCL world 1 at the tolerances: worst ratios {wa}")
        for p in ("p0", "p1"):
            log(f"    {p} (median of {DP_TIMED_STEPS} after {DP_WARM_STEPS} untimed, in this "
                f"order): no group {a1[p]['ms']:.3f} ms, NCCL world 1 {b1[p]['ms']:.3f} ms, "
                f"no group {a2[p]['ms']:.3f} ms, NCCL world 1 {b2[p]['ms']:.3f} ms; NCCL's "
                f"{b1[p]['collectives']} collectives ({b1[p]['collective_bytes'] / 1e6:.1f} MB) "
                f"replayed alone {b1[p]['collective_ms']:.3f} / {b2[p]['collective_ms']:.3f} ms"
                f" = {b1[p]['collective_ms'] / b1[p]['ms'] * 100:.1f} / "
                f"{b2[p]['collective_ms'] / b2[p]['ms'] * 100:.1f} % of the step; [6]'s "
                f"train_step {train_ms[int(p[1])]:.3f} ms {card}")
            log("      each timed step, ms: " + "; ".join(
                f"{n} {', '.join(f'{v:.1f}' for v in x[p]['ms_all'])}"
                for n, x in (("a1", a1), ("b1", b1), ("a2", a2), ("b2", b2))))

        # (b)'s floor: the one-process step's own float32 spread under exact
        # changes of its arithmetic: a rerun (K4's atomics), cuDNN's
        # autotuned algorithms, batch norm's statistics as the ranks combine
        # them
        cudnn.deterministic, cudnn.benchmark = False, True
        try:
            a3 = dp_steps(bundle, batch, held, warm=0, timed=1)
        finally:
            cudnn.deterministic, cudnn.benchmark = True, False
        r = dp_steps(bundle, batch, held, ranks_norm=True, warm=0, timed=1)
        floor_b = dp_floor(DP_FLOOR_K, a1, a2, a3, r)
        over, n_t, median, (most, where) = dp_floor_share(a1, floor_b)
        for name, x in (("autotuned", a3), ("batch norm by the ranks' rows", r)):
            log(f"    the no-group step, {name}, against the first, worst ratios without "
                f"a floor {dp_compare(x, a1)}")
        log(f"    (b)'s floor ({DP_FLOOR_K} x the largest change) over {DP_GRAD_RTOL:g} of "
            f"the scale in {over} of {n_t} gradient tensors; the median {median:.3g} of its "
            f"scale, the largest {most:.3g} at {where}")
        torch.save({"held": held, "a1": {p: a1[p] for p in ("p0", "p1")}, "floor": floor_b},
                   os.path.join(tmp, "ref.pt"))
        del held
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(rk), "--dp-world",
             str(DP_WORLD), "--dp-port", port, "--dp-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rk in range(DP_WORLD)]
        try:
            outs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rk, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"(b) gloo rank {rk} exited 0" + (
                "" if p.returncode == 0 else f":\n{o[-4000:]}"))
        ranks = []
        for rk in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{rk}.json")) as f:
                ranks.append(json.load(f))
        for rk, x in enumerate(ranks):
            log(f"    (b) rank {rk}: its discrete parts' differing pixel shares {x['flips']}; "
                f"against the one-process step, worst ratios {x['worst']}; without the "
                f"floor {x['worst_no_floor']}")
        check(all(f <= DP_FLIP_SHARE for x in ranks for fl in x["flips"].values() for f in fl),
              f"(b) each rank's own discrete parts within {DP_FLIP_SHARE:g} of the held "
              "ones' pixels")
        check(all(x["worst"][k] <= 1.0 for x in ranks
                  for k in ("metrics", "grads", "stats")),
              f"(b) {DP_WORLD} gloo ranks x {TRAIN_B // DP_WORLD} rows against the "
              f"one-process b{TRAIN_B} step: every loss within {DP_METRIC_RTOL:g} x max(1, "
              f"|loss|), each summed gradient within {DP_GRAD_RTOL:g} of its tensor's scale "
              f"or {DP_FLOOR_K} x the one-process step's own change, each running statistic "
              f"within {DP_STATS_RTOL:g} x max(1, its magnitude)")
        check(len({x["params_sha"] for x in ranks}) == 1
              and len({x["stats_sha"] for x in ranks}) == 1
              and all(x["step_metrics"] == ranks[0]["step_metrics"] for x in ranks),
              "(b) the ranks' parameters after p0 + p1, statistics and metrics bitwise equal")
        for p in ("p0", "p1"):
            r0 = ranks[0]
            log(f"    {p}: gloo rank step {r0[f'ms_{p}']:.3f} / {ranks[1][f'ms_{p}']:.3f} ms "
                f"(b{TRAIN_B // DP_WORLD} each, both on the one card), its "
                f"{r0[f'collectives_{p}']} collectives "
                f"({r0[f'collective_bytes_{p}'] / 1e6:.1f} MB through the host) replayed "
                f"alone {r0[f'collective_ms_{p}']:.3f} ms = "
                f"{r0[f'collective_ms_{p}'] / r0[f'ms_{p}'] * 100:.1f} % {card}")
        log(f"    [5m] took {time.perf_counter() - t_phase:.1f} s")
        return {"no_group_ms": [[x[p]["ms"] for x in (a1, a2)] for p in ("p0", "p1")],
                "nccl1_ms": [[x[p]["ms"] for x in (b1, b2)] for p in ("p0", "p1")],
                "nccl1_collective_ms": [[x[p]["collective_ms"] for x in (b1, b2)]
                                        for p in ("p0", "p1")],
                "gloo_ms": [[x[f"ms_{p}"] for x in ranks] for p in ("p0", "p1")],
                "gloo_collective_ms": [ranks[0][f"collective_ms_{p}"] for p in ("p0", "p1")],
                "worst_a": {k: wa[k] for k in ("metrics", "grads", "stats")},
                "worst_b": [{k: x["worst"][k] for k in ("metrics", "grads", "stats")}
                            for x in ranks],
                "flips_b": [x["flips"] for x in ranks]}
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 5n. the binning and fold modes
# ---------------------------------------------------------------------------

BIN_APPROX = 0.95  # the Renderer's default recall target
MODE_TIMES = 5  # CUDA-event calls whose median a time of [5n] is


def event_ms(fn, n: int = MODE_TIMES) -> float:
    """Median ms of n warm calls, each between two CUDA events."""
    import torch

    fn()
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def bin_modes_phase(bundle, system, img, face_verts, train_rows, op_rows, card) -> dict:
    """Phase 5n on infer's faces (b64, 224 px, the face region, the
    renderer's capacity): the binning functions against exact flat
    binning, `SmirkSystem.infer` and a b32 train step under the binning
    modes, the fold modes on both backwards' rows, and their times.
    train_rows: (slots (B,Tp,1024), g tile-major, bins, the per-slot
    magnitudes of the moments) of phase 4c; op_rows: (K7's rows, K6's
    bins) of phase 4f. The modes are restored however it ends."""
    import torch

    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train.trainer import SmirkSystem

    t_phase = time.perf_counter()
    S, cap = system.renderer.image_size, system.renderer.bin_capacity
    B, F = face_verts.shape[:2]
    fv = face_verts.detach()
    log(f"[5n] binning and fold modes: flat, approx {BIN_APPROX}, hier and sorted binning "
        f"at b{B}, {S} px, F={F}, capacity {cap}; infer and a b{TRAIN_B} train step under "
        "the modes; the four fold modes on both backwards")
    res = {}
    dispatched = []
    real = {n: getattr(R, n) for n in ("bin_faces_hier", "bin_faces_sorted")}

    def spy(name):
        def call(*a, **k):
            dispatched.append(name)
            return real[name](*a, **k)
        return call

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        for n in real:
            setattr(R, n, spy(n))
        with torch.inference_mode():
            # the binning functions against exact flat binning, bitwise
            ref = R.bin_faces_flat(fv, S, cap, with_misses=True)
            check(int(ref[2].sum()) == 0, "exact flat binning misses no face")
            variants = {
                "flat_approx": lambda: R.bin_faces_flat(fv, S, cap, BIN_APPROX, True),
                "hier": lambda: real["bin_faces_hier"](fv, S, cap, with_misses=True),
                "hier_approx": lambda: real["bin_faces_hier"](
                    fv, S, cap, approx=BIN_APPROX, with_misses=True),
                "sorted": lambda: real["bin_faces_sorted"](fv, S, cap, with_misses=True),
            }
            band = -(-S // (R.TILE_ROWS * R.BAND_TILES))
            per_band = torch.stack(R._bbox_and_priority(fv, S)[2:4], -1)
            r0 = torch.arange(band, device=fv.device) * R.TILE_ROWS * R.BAND_TILES
            in_band = ((per_band[..., 1][:, None] >= r0[None, :, None])
                       & (per_band[..., 0][:, None] <= r0[None, :, None] + 31)).sum(-1)
            log(f"    faces in the densest 32 px band {int(in_band.max())} (the coarse "
                f"list holds {R.COARSE_CAPACITY})")
            for name, fn in variants.items():
                bins, counts, misses = fn()
                if name == "sorted":
                    ok = misses == 0
                    log(f"    sorted: span-clipped incidences {int(misses.sum())} over "
                        f"{int((~ok).sum())} of {B} images; equality gated on the other "
                        f"{int(ok.sum())}")
                    check(bool(ok.any()), "sorted: some image has no span clip")
                    check(torch.equal(bins[ok], ref[0][ok]) and torch.equal(counts[ok],
                                                                           ref[1][ok]),
                          "sorted binning's bins and counts == exact flat's, bitwise")
                    continue
                check(int(misses.sum()) == 0, f"{name}: no selection misses")
                check(torch.equal(bins, ref[0]) and torch.equal(counts, ref[1]),
                      f"{name} binning's bins and counts == exact flat's, bitwise")
            # the times of the binning functions at b64
            timed = {"flat": lambda: R.bin_faces_flat(fv, S, cap),
                     "flat_misses": lambda: R.bin_faces_flat(fv, S, cap, with_misses=True),
                     **{k: variants[k] for k in ("flat_approx", "hier", "hier_approx")},
                     "hier_nomisses": lambda: real["bin_faces_hier"](fv, S, cap),
                     "sorted": variants["sorted"],
                     "sorted_nomisses": lambda: real["bin_faces_sorted"](fv, S, cap)}
            for name, fn in timed.items():
                res[f"bin_{name}_ms"] = event_ms(fn)

        # infer under the default, the hier and the sorted modes. A mode's
        # first call captures a graph of its own (the binning dispatched in
        # the warm-up and in the capture), its second replays it (nothing
        # dispatched); K1 launched once a call; the replays bitwise equal
        # to the captures' eager answers and to the default mode's replay
        modes = {"default": (False, None, False), "hier": (True, None, False),
                 "sorted": (False, None, True)}
        graphs = system.infer_graphs
        graphs.graphs.clear()  # so that the default mode captures here too
        outs = {}
        for name, mode in modes.items():
            R.set_bin_mode(*mode)
            want = {"default": [], "hier": ["bin_faces_hier"],
                    "sorted": ["bin_faces_sorted"]}[name]
            got = {}
            for call, runs, moves in (("capture", want * 2, (1, 0)), ("replay", [], (0, 1))):
                dispatched.clear()
                launches = {}
                before = graphs.captures, graphs.replays
                got[call] = _counted(launches, lambda: system.infer(img))
                moved = graphs.captures - before[0], graphs.replays - before[1]
                check(dispatched == runs and moved == moves
                      and launches["raster_fused_windows"] == 1,
                      f"infer's {call} under the {name} mode: dispatched "
                      f"{dispatched or ['flat']}, captures and replays +{moved}, K1 "
                      f"launched {launches['raster_fused_windows']} time(s)")
            differ = [k for k, v in got["replay"].items()
                      if not torch.equal(v, got["capture"][k])]
            check(not differ, f"infer's replay under the {name} mode == its capture's answer, "
                  f"bitwise (differing: {differ})")
            outs[name] = got["replay"]
            if name != "default":
                same = [k for k, v in outs[name].items() if not torch.equal(
                    v, outs["default"][k])]
                check(not same, f"infer under the {name} mode == the default's, bitwise "
                      f"({len(outs[name])} outputs; differing: {same})")
            check(int(outs[name]["raster_overflow"].sum()) == 0,
                  f"infer under the {name} mode: raster_overflow 0")
        R.set_bin_mode(False)

        # one b32 train step (p0) under sorted and under flat, lr 0, fresh
        # systems of one seed: the losses bitwise, K3 and K4's fold launched
        from smirk_tpu_torch import bench

        cudnn.deterministic, cudnn.benchmark = True, False
        batch = bench.train_batch(TRAIN_B, S, 0)
        metrics = {}
        for name, mode in (("sorted", (False, None, True)), ("flat", (False, None, False))):
            R.set_bin_mode(*mode)
            tsys = SmirkSystem(_variant(lr=0.0), bundle)
            gen = torch.Generator(device=tsys.device).manual_seed(0)
            launches = {}
            dispatched.clear()
            metrics[name] = _counted(launches, lambda: tsys.train_step(batch, 0, gen))[0]
            check(launches["raster_planes_windows"] >= 1
                  and launches["segment_moments_to_faces"] >= 1
                  and (name == "flat") == ("bin_faces_sorted" not in dispatched),
                  f"train_step p0 under {name}: K3 {launches['raster_planes_windows']}, K4's "
                  f"fold {launches['segment_moments_to_faces']} launch(es), "
                  f"{dispatched.count('bin_faces_sorted')} sorted binnings")
            del tsys
        R.set_bin_mode(False)
        diff = [k for k in metrics["flat"] if metrics["flat"][k] != metrics["sorted"][k]]
        check(not diff and len(metrics["flat"]) > 0,
              f"train_step p0 losses under sorted == flat, bitwise ({len(metrics['flat'])} "
              f"metrics; differing: {diff})")
        cudnn.deterministic, cudnn.benchmark = saved

        # the fold modes: the training backward's rows (K4's store; "matmul"
        # = K4's fold epilogue) and the op path's (K7's rows; "matmul" = K5)
        slots, g_t, bins_t, k4_scale = train_rows
        rows7, bins7 = op_rows
        with torch.inference_mode():
            store = R.segment_moments(slots, g_t, cap, S)
            scale_t = R.fold_slots_to_faces_plain(k4_scale, bins_t, F)
            scale_o = R.fold_slots_to_faces_plain(rows7.abs(), bins7, F)
            ratios = {}
            for mode in R.FOLD_MODES:
                R.set_fold_mode(mode)
                launches = {}
                if mode == "matmul":
                    want_t = _counted(launches, lambda: R.segment_moments_to_faces(
                        slots, g_t, bins_t, cap, S, F))
                    want_o = _counted(launches, lambda: R.fold_slots_to_faces(
                        rows7, bins7, F))
                    check(launches["segment_moments_to_faces"] == 1
                          and launches["fold_slots_to_faces"] == 1,
                          "matmul: K4's fold and K5 launched")
                    res["fold_train_matmul_ms"] = event_ms(lambda: R.segment_moments_to_faces(
                        slots, g_t, bins_t, cap, S, F))
                    res["fold_op_matmul_ms"] = event_ms(lambda: R.fold_slots_to_faces(
                        rows7, bins7, F))
                    continue
                got_t = _counted(launches, lambda: R.fold_slots_to_faces(store, bins_t, F))
                got_o = _counted(launches, lambda: R.fold_slots_to_faces(rows7, bins7, F))
                check(launches["fold_slots_to_faces"] == 0, f"{mode}: K5 not launched")
                ratios[mode] = (
                    within(got_t, want_t, scale_t, f"{mode} fold of K4's store rows vs "
                           "K4's fold epilogue (training backward)")[0],
                    within(got_o, want_o, scale_o, f"{mode} fold of K7's rows vs K5 "
                           "(op path backward)")[0])
                res[f"fold_train_{mode}_ms"] = event_ms(
                    lambda: R.fold_slots_to_faces(store, bins_t, F))
                res[f"fold_op_{mode}_ms"] = event_ms(
                    lambda: R.fold_slots_to_faces(rows7, bins7, F))
        R.set_fold_mode("matmul")
        # the fold modes reach both backwards end to end, at b4: the
        # training backward (rasterize_planes_diff: K4's store and the
        # mode's fold, K4's fold epilogue under "matmul") and the op path's
        # (rasterize at D = 9: K7, then the mode's fold, K5 under "matmul"),
        # each gradient within 1e-4 x `dense_gradient_and_scale`'s rounding
        # scale of "matmul"'s
        fvg = face_verts[:4].detach().clone()
        nrm = torch.nn.functional.normalize(fvg, dim=-1)
        attr9 = torch.cat([nrm, nrm * 0.5, fvg], -1)
        gen = torch.Generator(device=fvg.device).manual_seed(15)
        g3 = torch.randn((len(fvg), S, S, 3), generator=gen, device=fvg.device)
        g9 = torch.randn((len(fvg), S, S, 9), generator=gen, device=fvg.device)
        grads = {}
        for mode in ("matmul",) + tuple(m for m in R.FOLD_MODES if m != "matmul"):
            R.set_fold_mode(mode)
            launches = {}

            def step():
                a, n = fvg.clone().requires_grad_(True), nrm.clone().requires_grad_(True)
                vals, _, p2f, _ = R.rasterize_planes_diff(
                    a, n, S, cap, compact=system.renderer.raster_compact)
                return p2f, torch.autograd.grad((vals * g3).sum(), (a, n))
            p2f, grads[mode] = _counted(launches, step)
            fold_k = ("segment_moments_to_faces" if mode == "matmul" else "segment_moments")
            check(launches[fold_k] == 1 and launches["fold_slots_to_faces"] == 0
                  and all(bool(torch.isfinite(x).all()) for x in grads[mode]),
                  f"rasterize_planes_diff's backward under {mode}: {fold_k} launched, K5 not")
            launches = {}

            def op_step():
                a9 = attr9.clone().requires_grad_(True)
                vals9, _, p9, _ = R.rasterize(fvg, a9, S, 512)
                return p9, torch.autograd.grad((vals9 * g9).sum(), (a9,))
            p9, g_op = _counted(launches, op_step)
            grads[mode] += g_op
            check(launches["segment_reduce_tiles"] == 1
                  and launches["fold_slots_to_faces"] == (mode == "matmul")
                  and bool(torch.isfinite(g_op[0]).all()),
                  f"rasterize's D=9 backward under {mode}: K7 launched, K5 "
                  f"{launches['fold_slots_to_faces']} time(s)")
        R.set_fold_mode("matmul")
        _, sc_fv, _, sc_n = R.dense_gradient_and_scale(p2f, fvg, nrm, g3)
        _, _, _, sc_9 = R.dense_gradient_and_scale(p9, fvg, attr9, g9, weighted=False)
        for mode in R.FOLD_MODES:
            if mode == "matmul":
                continue
            worst = [within(got, want, sc, f"{mode}: the {what} gradient vs matmul's",
                            rtol=1e-4)[0]
                     for got, want, sc, what in zip(
                         grads[mode], grads["matmul"], (sc_fv, sc_n, sc_9),
                         ("training backward's face_verts", "training backward's normals",
                          "op path's D=9 attribute"))]
            ratios[mode] += tuple(worst)
        check(float(grads["matmul"][2].abs().sum()) > 0, "the op path's gradient is nonzero")

        # infer with the miss check armed and disarmed, alternating
        rnd = system.renderer
        armed0 = rnd.bin_miss_check_fused
        times = {True: [], False: []}
        for i in range(2 * MODE_TIMES):
            rnd.bin_miss_check_fused = i % 2 == 0
            times[rnd.bin_miss_check_fused].append(event_ms(lambda: system.infer(img), 1))
        rnd.bin_miss_check_fused = armed0
        res["infer_miss_check_armed_ms"] = statistics.median(times[True])
        res["infer_miss_check_disarmed_ms"] = statistics.median(times[False])
    finally:
        for n, fn in real.items():
            setattr(R, n, fn)
        R.set_bin_mode(False)
        R.set_fold_mode("matmul")
        cudnn.deterministic, cudnn.benchmark = saved
    for k, v in res.items():
        log(f"    {k:34s} {v:10.4f} ms (CUDA events, median of {MODE_TIMES}) {card}")
    log(f"    fold modes' worst ratios (training rows, op path rows: of 1e-5 x the sum "
        f"of magnitudes; face_verts, normals, D=9 gradients: of 1e-4 x the rounding "
        f"scale): {json.dumps({k: [round(x, 4) for x in v] for k, v in ratios.items()})}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"    [5n] took {res['phase_s']:.1f} s")
    return res


# the reference's shape (phase 5o): seeded frames of FRAME_HW through the
# landmark crop, one at a time, held against b8 calls on the same frames
# (the parameters, vertices and landmarks within B1_ATOL; pix_to_face on
# B1_AGREE of each frame's pixels, the render within B1_ATOL where it
# agrees); the video demo's frames
B1_FRAMES, B1_REF_B, B1_ATOL, B1_AGREE = 20, 8, 1e-4, 0.995
VIDEO_FRAMES = 16
B1_KEYS = ("pose_params", "cam", "shape_params", "expression_params", "eyelid_params",
           "jaw_params", "vertices", "landmarks_fan", "landmarks_mp")
# the pretrain recipe (phase 5p): CLI steps at TRAIN_B, then the step timed
# at lr 0: warm steps, then timed ones (their median)
PRETRAIN_RECIPE = "configs/config_pretrain.yaml"
PRETRAIN_WARM, PRETRAIN_TIMED = 2, 5


def frame_landmarks(lmk_ndc, S):
    """Landmarks (B,K,2) in NDC of the render -> (the same points in a
    FRAME_HW frame about its centre, at the scale that makes the 1.4 x
    bbox crop CROP_OVER_S x S px, so that the crop is a downscale and the
    hull covers the rendered face; that scale)."""
    import numpy as np

    FH, FW = FRAME_HW
    bbox = np.ptp(lmk_ndc, axis=1).mean() * S / 2  # mean side in the render's pixels
    scale = CROP_OVER_S * S / (1.4 * bbox)
    return lmk_ndc * (S / 2 * scale) + np.float32([FW / 2, FH / 2]), scale


def batch1_rule(one, ref, renderer, what):
    """One frame's outputs (each (1, ...)) against its row of a batched
    call, all gates: B1_KEYS within B1_ATOL, pix_to_face on >= B1_AGREE
    of the pixels, and the render within B1_ATOL where pix_to_face agrees
    (each pixel past it printed first, with the winning face's area in
    pixels); and the row's own vertices and cam rendered alone at b1
    (`renderer`) bitwise equal to the row's render and pix_to_face (the
    render does not depend on the batch, so what differs comes from the
    encoder). -> (worst |diff| of B1_KEYS, the pixels' agreement, the
    render's worst |diff| where it agrees)."""
    import numpy as np
    import torch

    from smirk_tpu_torch.device import fp32_math

    err = max(float(np.abs(one[k] - ref[k]).max()) for k in B1_KEYS)
    agree = one["pix_to_face"] == ref["pix_to_face"]
    share = float(agree.mean())
    diff = np.where(agree[..., None], np.abs(one["rendered_img"] - ref["rendered_img"]),
                    0).max(-1)
    r_err, past = float(diff.max()), int((diff > B1_ATOL).sum())
    check(err <= B1_ATOL and share >= B1_AGREE,
          f"{what}: parameters, vertices, landmarks within {err:.2e} <= {B1_ATOL:g}; "
          f"pix_to_face agrees on {share:.5f} >= {B1_AGREE}")
    dev, S = renderer.faces.device, renderer.image_size
    with fp32_math(), torch.inference_mode():
        v, cam = (torch.as_tensor(ref[k], device=dev) for k in ("vertices", "cam"))
        alone = {k: t.cpu().numpy() for k, t in renderer(v, cam, inference=True).items()}
        fv = renderer._face_geometry(v, renderer.project(v, cam))[0][0].cpu().numpy()
    check(all(np.array_equal(alone[k], ref[k]) for k in ("rendered_img", "pix_to_face")),
          f"{what}: the row's vertices rendered alone == the row's render (bitwise)")
    if past:
        worst5 = np.argsort(diff, axis=None)[::-1][:5]  # the worst pixels' faces
        areas = []
        for _, y, x in zip(*np.unravel_index(worst5[diff.flat[worst5] > B1_ATOL], diff.shape)):
            tri = fv[int(one["pix_to_face"][0, y, x]), :, :2] * (S / 2)
            e1, e2 = tri[1] - tri[0], tri[2] - tri[0]
            areas.append(0.5 * abs(float(e1[0] * e2[1] - e1[1] * e2[0])))
        log(f"    {what}: {past} pixel(s) where pix_to_face agrees differ by more than "
            f"{B1_ATOL:g} (worst {r_err:.4e}); the winning faces' areas at the worst "
            f"{len(areas)}: {[round(a, 4) for a in areas]} px^2; the vertices differ by "
            f"{float(np.abs(one['vertices'] - ref['vertices']).max()):.2e}")
    check(r_err <= B1_ATOL,
          f"{what}: the render within {r_err:.2e} <= {B1_ATOL:g} where pix_to_face agrees")
    return err, share, r_err


def batch1_phase(pred, bundle, lmk_ndc, card) -> dict:
    """Phase 5o, the reference's shape: batch 1, one frame at a time. (a)
    `Predictor.__call__` on B1_FRAMES seeded FRAME_HW frames through the
    landmark crop, one call each on the card, K1 once a call, each frame
    against its row of b8 calls, p50 / p90 ms a frame (host preparation
    and the copy back included); (b) `cli.demo.main` on one seeded PNG
    with its landmarks, --crop, with and without --use_smirk_generator
    --render_orig; (c) `cli.demo_video.main` on VIDEO_FRAMES seeded frames
    with a landmark track, --crop, at --batch 1 and 8, with and without
    the generator. Neither demo is given --device. lmk_ndc: the main
    path's landmarks_mp, mapped into the frames -> ({field: value},
    launches)."""
    import contextlib
    import importlib.util
    import io
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from smirk_tpu_torch import assets
    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    S = pred.image_size
    FH, FW = FRAME_HW
    log(f"[5o] the reference's shape: Predictor.__call__ at b1 on {B1_FRAMES} {FH}x{FW} "
        f"frames through the landmark crop, cli.demo, cli.demo_video at --batch 1 and "
        f"{B1_REF_B} {card}")
    res, launches = {}, {}
    n = max(B1_FRAMES, VIDEO_FRAMES)
    frames = np.random.default_rng(16).integers(0, 256, (n, FH, FW, 3), dtype=np.uint8)
    lmks, _ = frame_landmarks(lmk_ndc[:n], S)

    # (a) one frame a call; the first call (b1's cuDNN plans) is not timed
    pred(frames[0], lmks[0])
    torch.cuda.synchronize()
    ones, ms, per_call = [], [], []
    for i in range(B1_FRAMES):
        R.reset_launch_counts()
        t = time.perf_counter()
        ones.append(pred(frames[i], lmks[i]))
        ms.append((time.perf_counter() - t) * 1e3)
        per_call.append(R.raster_fused_windows.launches)
        launches["raster_fused_windows"] = (launches.get("raster_fused_windows", 0)
                                            + per_call[-1])
    check(per_call == [1] * B1_FRAMES, f"K1 launched once a b1 call ({per_call})")
    for o in ones:
        check(o["rendered_img"].shape == (1, S, S, 3) and all(
            np.isfinite(v).all() for v in o.values()), "a b1 call: (1, S, S, 3), finite")
        check(int(o["raster_overflow"].max()) == 0, "a b1 call: no raster overflow")
    rows = {}
    for c0 in sorted({*range(0, B1_FRAMES - B1_REF_B + 1, B1_REF_B), B1_FRAMES - B1_REF_B}):
        ref = pred(frames[c0:c0 + B1_REF_B], lmks[c0:c0 + B1_REF_B])
        rows.update((c0 + j, {k: v[j:j + 1] for k, v in ref.items()})
                    for j in range(B1_REF_B))
    rule = [batch1_rule(ones[i], rows[i], pred.system.renderer,
                        f"frame {i} at b1 against its row of a b{B1_REF_B} call")
            for i in range(B1_FRAMES)]
    res.update(b1_worst_param_err=max(r[0] for r in rule), b1_min_agree=min(r[1] for r in rule),
               b1_worst_render_err=max(r[2] for r in rule))
    q = np.percentile(ms, [50, 90])
    res["predictor_b1_p50_ms"], res["predictor_b1_p90_ms"] = float(q[0]), float(q[1])
    log(f"    Predictor.__call__ at b1 (host preparation, the crop and the copy back "
        f"included): p50 {q[0]:.3f} ms, p90 {q[1]:.3f} ms a frame over {B1_FRAMES} calls "
        f"(min {min(ms):.3f}, max {max(ms):.3f}, spread {spread(sorted(ms)):.1f} %); every "
        f"call {json.dumps([round(x, 3) for x in ms])} {card}")

    check(importlib.util.find_spec("PIL") is not None,
          "PIL is installed (the demos read and write their image files with it)")
    from smirk_tpu_torch.cli import demo, demo_video
    from smirk_tpu_torch.utils.viz import save_image

    def save_frame(frame, path):  # uint8 -> the same uint8 in the file
        save_image((frame + 0.5) / 255.0, path)

    def read_image(out_dir):  # the one image file the run wrote there
        return next(demo_video.iter_frames(out_dir))

    tmp = tempfile.mkdtemp(prefix="smirk_demo_")
    load_all, panel, infer = assets.load_all, demo.panel, trainer.SmirkSystem.infer
    assets.load_all = lambda *a, **kw: bundle
    try:
        # (b) the image demo, no --device: the card
        img_path, lmk_path = os.path.join(tmp, "face.png"), os.path.join(tmp, "face.npy")
        save_frame(frames[0], img_path)
        np.save(lmk_path, lmks[0])
        grids = []

        def kept_panel(*a, **kw):
            grids.append(panel(*a, **kw))
            return grids[-1]

        demo.panel = kept_panel
        for flags, shape in (([], (S, 2 * S, 3)),
                             (["--use_smirk_generator", "--render_orig"], (FH, 3 * FW, 3))):
            out_dir = os.path.join(tmp, "demo_" + str(len(flags)))
            R.reset_launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                demo.main(["--input_path", img_path, "--landmarks", lmk_path, "--crop",
                           "--out_path", out_dir, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            k1 = R.raster_fused_windows.launches
            launches["raster_fused_windows"] += k1
            written = read_image(out_dir)
            what = ("cli.demo --crop " + " ".join(flags)).rstrip()
            check(grids[-1].shape == written.shape == shape and np.isfinite(grids[-1]).all(),
                  f"{what}: the panel {written.shape} written, the JAX CLI's {shape}, finite")
            check(k1 == 1, f"{what}: K1 launched ({k1})")
            res[f"demo_{'generator' if flags else 'plain'}_s"] = wall
        demo.panel = panel

        # (c) the video demo on a directory of frames with a landmark track
        frame_dir = os.path.join(tmp, "frames")
        os.makedirs(frame_dir)
        for i in range(VIDEO_FRAMES):
            save_frame(frames[i], os.path.join(frame_dir, f"{i:03d}.png"))
        track = os.path.join(tmp, "track.npy")
        np.save(track, lmks[:VIDEO_FRAMES])
        seen = {}

        def kept_infer(self, img):
            out = infer(self, img)
            seen[run].append({k: v.cpu().numpy() for k, v in out.items()})
            return out

        trainer.SmirkSystem.infer = kept_infer
        for gen_flag in ([], ["--use_smirk_generator"]):
            for batch in (1, B1_REF_B):
                run = (batch, bool(gen_flag))
                seen[run] = []
                out_dir = os.path.join(tmp, f"video_{batch}_{len(gen_flag)}")
                R.reset_launch_counts()
                buf = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    demo_video.main(["--input_path", frame_dir, "--landmarks", track, "--crop",
                                     "--batch", str(batch), "--out_path", out_dir, *gen_flag])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                k1 = R.raster_fused_windows.launches
                launches["raster_fused_windows"] += k1
                chunks = -(-VIDEO_FRAMES // batch)
                what = f"cli.demo_video --crop --batch {batch} {' '.join(gen_flag)}".rstrip()
                names = sorted(f for f in os.listdir(out_dir) if f.startswith("frame_"))
                cols = 3 if gen_flag else 2
                shape = read_image(out_dir).shape
                check(len(names) == VIDEO_FRAMES and shape == (S, cols * S, 3),
                      f"{what}: {len(names)} frames written, {shape}")
                check(k1 == chunks and len(seen[run]) == chunks,
                      f"{what}: K1 launched once a chunk ({k1} for {chunks})")
                fps = [ln for ln in buf.getvalue().splitlines() if ln.startswith("device fps:")]
                dev_fps = float(fps[0].split()[2]) if fps else float("nan")
                key = f"video_b{batch}{'_generator' if gen_flag else ''}"
                res[f"{key}_ms_per_frame"] = 1e3 / dev_fps
                res[f"{key}_wall_ms_per_frame"] = wall * 1e3 / VIDEO_FRAMES
                log(f"    {what}: {1e3 / dev_fps:.3f} ms a frame (the demo's own clock: "
                    f"prepare + infer{' + generator' if gen_flag else ''} + synchronize, the "
                    f"first chunk left out); the whole run {wall * 1e3 / VIDEO_FRAMES:.3f} ms a "
                    f"frame (system build, file IO and the video's assembly included) {card}")
        b1 = {k: np.concatenate([o[k] for o in seen[(1, False)]]) for k in seen[(1, False)][0]}
        b8 = {k: np.concatenate([o[k] for o in seen[(B1_REF_B, False)]])
              for k in seen[(B1_REF_B, False)][0]}
        rule = [batch1_rule({k: v[i:i + 1] for k, v in b1.items()},
                            {k: v[i:i + 1] for k, v in b8.items()}, pred.system.renderer,
                            f"cli.demo_video frame {i}: --batch 1 against --batch {B1_REF_B}")
                for i in range(VIDEO_FRAMES)]
        res["video_worst_render_err"] = max(r[2] for r in rule)
    finally:
        assets.load_all, demo.panel, trainer.SmirkSystem.infer = load_all, panel, infer
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"    [5o] took {res['phase_s']:.1f} s")
    return res, launches


def _mica_tar(generator):
    """A seeded mica.tar object in the reference layout: {'arcface': ...,
    'flameModel': {'regressor.*'}} at full depth (`_he_state_dict`)."""
    from smirk_tpu_torch.models.mica import Mica

    mica = _he_state_dict(Mica(), generator)
    return {"arcface": {k[8:]: v for k, v in mica.items() if k.startswith("arcface.")},
            "flameModel": {k: v for k, v in mica.items() if k.startswith("regressor.")}}


class _RenderKept:
    """The system's renderer, every call's outputs kept in `seen`."""

    def __init__(self, renderer, seen):
        self.renderer, self.seen = renderer, seen

    def __call__(self, *a, **kw):
        out = self.renderer(*a, **kw)
        self.seen.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def pretrain_phase(bundle, train_ms, card) -> dict:
    """Phase 5p, the pretrain recipe: `cli.train.main` on
    configs/config_pretrain.yaml --synthetic at TRAIN_B for CLI_STEPS steps
    in this process, SMIRK_MICA at a seeded full-depth mica.tar: every
    metric finite, the landmark and MICA losses nonzero, no generator and no
    cycle metric, no raster overflow, K1 once a step and K3 never, all three
    sub-encoders moved; one `_loss1` whose render (K1) does not reach the
    total and raises no warning from the op; then `SmirkSystem.train_step`
    under the recipe at lr 0, timed -> ({field: value}, launches)."""
    import os
    import shutil
    import tempfile
    import warnings

    import torch

    from smirk_tpu_torch import assets, bench, kernels
    from smirk_tpu_torch.cli import train as train_cli
    from smirk_tpu_torch.config import load_config
    from smirk_tpu_torch.device import fp32_math
    from smirk_tpu_torch.models import teachers
    from smirk_tpu_torch.render import rasterizer as R
    from smirk_tpu_torch.train.trainer import SUB_ENCODERS, SmirkSystem

    t_phase = time.perf_counter()
    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)), PRETRAIN_RECIPE)
    log(f"[5p] the pretrain recipe: cli.train {PRETRAIN_RECIPE} --synthetic at b{TRAIN_B}, "
        f"{CLI_STEPS} steps, MICA at full depth from a seeded file; then its train_step "
        f"timed at lr 0 {card}")
    res, launches = {}, {}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pretrain_", dir=kernels.BUILD_DIR)
    mica_path = os.path.join(tmp, "mica.tar")
    torch.save(_mica_tar(torch.Generator().manual_seed(0)), mica_path)
    logdir = os.path.join(tmp, "run")
    overrides = [f"train.batch_size={TRAIN_B}", "train.num_epochs=1",
                 f"train.num_workers={CLI_WORKERS}",
                 "train.visualize_every=0", "train.log_losses_every=1",
                 f"train.log_path={logdir}"]
    steps, state = [], {}
    step_fn, load_all = SmirkSystem.train_step, assets.load_all
    saved_env = {k: os.environ.get(k) for k in ("SMIRK_MICA", "SMIRK_SYNTH_LEN")}

    def counted_step(self, *a, **kw):
        if not steps:
            state["system"] = self
            state["first"] = {n: p.detach().clone() for n, p in self.encoder.named_parameters()}
        R.reset_launch_counts()
        out = step_fn(self, *a, **kw)
        torch.cuda.synchronize()
        steps.append({k.__name__: k.launches for k in R.KERNELS})
        return out

    SmirkSystem.train_step = counted_step
    assets.load_all = lambda *a, **kw: bundle
    os.environ["SMIRK_MICA"] = mica_path
    os.environ["SMIRK_SYNTH_LEN"] = str(CLI_STEPS * TRAIN_B)  # the epoch: CLI_STEPS steps
    try:
        t = time.perf_counter()
        train_cli.main([recipe, "--synthetic", *overrides])
        res["cli_s"] = time.perf_counter() - t
        SmirkSystem.train_step = step_fn
        system = state["system"]
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["phase"] == "train"]
        check(len(train_recs) == CLI_STEPS == len(steps), f"{CLI_STEPS} pretrain steps logged")
        check(all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float)),
              f"every metrics.jsonl record finite ({len(recs)} records)")
        check(all(r[k] > 0 for r in train_recs for k in (
            "landmark_loss_fan", "landmark_loss_mp", "mica_loss")),
            "landmark_loss_fan, landmark_loss_mp and mica_loss nonzero at every step ("
            + ", ".join(f"{k} {train_recs[-1][k]:.5g}" for k in (
                "landmark_loss_fan", "landmark_loss_mp", "mica_loss")) + " at the last)")
        check(system.generator is None and system.mica is not None
              and not any(k in r for r in train_recs for k in (
                  "loss_second_path", "cycle_loss", "raster_overflow_2nd")),
              "no generator, no loss_second_path and no cycle metric; the MICA teacher loaded")
        check(all(r["raster_overflow"] == 0 for r in train_recs), "raster_overflow == 0")
        check(all(st["raster_fused_windows"] == 1 and st["raster_planes_windows"] == 0
                  and st["segment_moments_to_faces"] == 0 for st in steps),
              f"K1 once a step, and neither K3 nor K4's fold ({steps[0]})")
        launches = {k: sum(st[k] for st in steps) for k in steps[0]}
        last = dict(system.encoder.named_parameters())
        moved = {sub: max(float((last[n].detach() - p).abs().max())
                          for n, p in state["first"].items() if n.startswith(sub))
                 for sub in SUB_ENCODERS}
        check(all(v > 0 for v in moved.values()),
              f"all three sub-encoders moved between the first and the last step "
              f"(max |change| {json.dumps({k: float(f'{v:.3g}') for k, v in moved.items()})})")
        t_steps = [r["t"] for r in train_recs]
        res["cli_steps_s"] = (len(t_steps) - 1) / max(t_steps[-1] - t_steps[0], 1e-9)

        # the render under a requires-grad encoder: K1, no grad to the image
        batch = system._batch(bench.train_batch(TRAIN_B, system.config.image_size, 0))
        seen = []
        system.renderer = _RenderKept(system.renderer, seen)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with fp32_math():
                    total, _ = _counted(launches, lambda: system._loss1(batch, True))
                    system._grads(total, system.enc_params)
                torch.cuda.synchronize()
        finally:
            system.renderer = system.renderer.renderer
            system._eval_mode()
        rend = seen[0]
        check(total.requires_grad and rend["landmarks_fan"].requires_grad
              and not rend["rendered_img"].requires_grad
              and rend["rendered_img"].grad_fn is None,
              "the total reaches the landmarks and not rendered_img (K1's outputs carry no "
              "graph)")
        ours = [str(w.message) for w in caught if any(s in str(w.message) + w.filename for s in (
            "autograd", "raster_fused", "smirk_tpu_torch"))]
        check(not ours, f"no warning from K1's op or the port in the step ({ours}; "
              f"{len(caught)} warnings in all)")

        # the step at lr 0 on the recipe's config: host clock, synchronized
        config = load_config(recipe, tuple(overrides) + ("train.lr=0",))
        timed = SmirkSystem(config, bundle,
                            mica_variables=teachers.load_mica_teacher(mica_path, None))
        tb = bench.train_batch(TRAIN_B, config.image_size, 0)
        gen = torch.Generator(device=timed.device).manual_seed(0)
        ms = []
        for i in range(PRETRAIN_WARM + PRETRAIN_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m, _ = _counted(launches, lambda: timed.train_step(tb, i, gen))
            ms.append((time.perf_counter() - t) * 1e3)
        ms = sorted(ms[PRETRAIN_WARM:])
        check(math.isfinite(m["loss_first_path"]) and m["raster_overflow"] == 0,
              "the timed steps: finite, no raster overflow")
        res["pretrain_step_ms"] = statistics.median(ms)
        res["pretrain_step_spread_pct"] = spread(ms)
        log(f"    pretrain train_step at b{TRAIN_B}, lr 0: median {res['pretrain_step_ms']:.3f} "
            f"ms of {PRETRAIN_TIMED} after {PRETRAIN_WARM} warm (host clock, each ended by a "
            f"synchronize; every run {json.dumps([round(x, 3) for x in ms])}, spread "
            f"{res['pretrain_step_spread_pct']:.1f} %) against [6]'s fp32 p0 step "
            f"{train_ms[0]:.3f} ms; the CLI {res['cli_steps_s']:.3f} steps/s, its run "
            f"{res['cli_s']:.1f} s {card}")
        del timed, system, state
        torch.cuda.empty_cache()
    finally:
        SmirkSystem.train_step = step_fn
        assets.load_all = load_all
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"    [5p] took {res['phase_s']:.1f} s")
    return res, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at batch 8, then stop")
    # a gloo rank of phase 5m, started by the script itself
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-world", type=int, default=DP_WORLD, help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from smirk_tpu_torch import Predictor, bench, kernels, native
        from smirk_tpu_torch.render import rasterizer as R
    except ImportError as e:
        print(f"chip_smoke: the smirk_tpu_torch package is not here ({e})",
              file=sys.stderr)
        return 2
    if args.dp_rank is not None:
        return dp_rank_main(args)

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
    bundle = recentred_head()
    vt = bundle["v_template"]
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
        _, _, _, ovf3 = R.rasterize_planes_diff(fvt, fnt, S, cap, compact=tb)
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
    # the native host ops' first use on this machine ([5l] reads it); the
    # loader's workers of [5f] then only load the library
    native_build = native.build(force=True)
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
    # ---------------- 5l-5m. the native host ops, data parallel ----------------
    native_info = native_phase(native_build, cli_info["loader_images_s"], train_ms, card)
    log("    " + json.dumps(native_info))
    dp_info = dp_phase(bundle, train_ms, card)
    log("    " + json.dumps(dp_info))
    # ---------------- 5n. the binning and fold modes ----------------
    modes_info = bin_modes_phase(bundle, system, img, face_verts,
                                 (slots3, g_t, bins_t, k4_scale), (k7, b5op), card)
    log("    " + json.dumps(modes_info))

    # ---------------- 5o-5p. batch 1 and the demos, the pretrain recipe ----------------
    b1_info, b1_launches = batch1_phase(pred, bundle, out["landmarks_mp"][..., :2], card)
    log("    " + json.dumps(b1_info))
    pre_info, pre_launches = pretrain_phase(bundle, train_ms, card)
    log("    " + json.dumps(pre_info))

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
         + teach_launches.get("raster_fused_windows", 0)
         + b1_launches["raster_fused_windows"] + pre_launches["raster_fused_windows"],
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
