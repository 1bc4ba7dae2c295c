"""Profiling and debugging (port of smirk_tpu/utils/profiling.py).

  * `trace(logdir)`: a `torch.profiler.profile` context over the CPU and,
    when there is one, the CUDA card, exporting a Chrome trace
    (`logdir/trace.json`, viewable in Perfetto) on exit;
  * `span(name)`: a named range of the program (`SPANS`) on the
    profiler's own clock, recorded only while a profiler records;
  * `enable_nan_debugging()`: autograd's anomaly detection, which names
    the forward operation of a backward that produced NaN.
"""
from __future__ import annotations

import contextlib
import os

import torch

# The program's spans, each opened by `span` at a layer boundary of
# `train.trainer.SmirkSystem` (the renderer's binning excepted). A name may
# repeat under different parents; `smirk.train_step` and `smirk.infer` are
# the roots, `smirk.phase1` / `smirk.phase2` the training step's phases. On
# a CUDA device infer runs in `smirk.infer.capture` or `smirk.infer.replay`;
# a replay runs no Python of the body, so the encoder, FLAME and render
# spans under infer appear only in a capture.
SPANS = (
    "smirk.train_step",  # SmirkSystem.train_step, its whole body
    "smirk.infer",       # SmirkSystem.infer, its whole body
    "smirk.infer.capture",  # infer's first call of a key on a CUDA device:
                            # the body run eagerly, then captured
    "smirk.infer.replay",   # infer's later calls there: the input copied
                            # in, the graph replayed, its outputs cloned
    "smirk.batch",       # the batch to the device (_batch)
    "smirk.phase1",      # path 1: forward, backward, both Adam updates
    "smirk.phase2",      # the cycle path: forward, backward, one Adam update
    "smirk.encoder",     # an encoder apply: trained, frozen or serving
    "smirk.teacher",     # a no-grad teacher apply: the base encoder, MICA
    "smirk.flame",       # an apply of the FLAME layer
    "smirk.render",      # a Renderer call, binning included
    "smirk.render.bin",  # the raster's binning (rasterizer.bin_faces)
    "smirk.masking",     # the mask's draws, sample_mesh_points,
                         # transfer_pixels, compose_mask, the generator input
    "smirk.augment",     # the cycle path's row gather and _augment_feats
    "smirk.generator",   # a generator apply: trained or frozen
    "smirk.losses",      # loss arithmetic, VGG16's perceptual pass and the
                         # emotion term (its frozen generator apply included)
    "smirk.backward",    # a _grads call: autograd.grad, the all-reduce
    "smirk.adam",        # a phase's Adam update(s), the generator's clip
    "smirk.readback",    # the step's metrics to the host (_floats)
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` range while the torch
    profiler records, else one shared no-op context (enter and exit cost
    well under a microsecond). Also a no-op while torch.compile or
    torch.export traces, so that no profiler op enters a traced graph.
    `name` is one of `SPANS`."""
    if (not torch._C._autograd._profiler_enabled() or torch.compiler.is_compiling()
            or torch.compiler.is_exporting()):
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
