"""SMIRK system: encoders + FLAME + renderer + fuse generator, with the
serving path and the two-path training step (port of
smirk_tpu/train/trainer.py).

`SmirkSystem.infer` is the serving path: image batch -> FLAME parameters,
geometry and the fused render, on a CUDA device one replayed CUDA graph per
input shape (`InferGraphs`); `reconstruct` takes infer's outputs on to
the analysis-by-neural-synthesis image (mesh-anchored pixel hints, the
hull-masked input, the fuse generator). `train_step` is one training
iteration:

  * path 1 (`_loss1`): encoders (train-mode batch norm on all three) ->
    FLAME -> the differentiable render -> landmark, regularization and,
    with the fuse generator, masked-reconstruction losses; one backward,
    then the encoder's and the generator's Adam steps;
  * path 2, the cycle (`_loss2`, when the generator is on and its weight
    is > 0): augmented parameters are rendered without gradient (the fused
    inference raster), the generator reconstructs the image from the
    render and mesh-anchored pixel hints, the encoder re-encodes it, and
    the cycle loss ties the re-encoded parameters to the augmented ones.
    Even parities freeze the encoder (eval-mode batch norm, no update; the
    gradient still flows through it to the generator), odd parities freeze
    the generator (eval-mode batch norm, detached output).

State lives in the modules and the optimizers, and `step` counts training
iterations. The learning rates follow a cosine schedule restarted every
epoch, indexed by that counter, not by the optimizers' update counts.

Differences from the JAX package, by design:
  * `train.step_mode` ("split" / "fused") picks how many jitted programs
    the JAX package compiles; eager PyTorch has nothing to split, so it is
    read by nothing here;
  * the compute dtype (`arch.bf16_compute`) and the cycle path's frozen
    dtype (`arch.bf16_cycle_frozen`) are arguments of the encoder's and
    the generator's `forward`, not second modules: one set of weights, as
    the JAX package's twins share their variables;
  * `train.remat_cycle` wraps the cycle's four applies in
    torch.utils.checkpoint; a recomputed forward leaves the running
    statistics alone (`mobilenetv3.frozen_stats`), so they move once, as
    jax.checkpoint's functional statistics do;
  * the teachers (`vgg_variables`, `emotion_variables`, `mica_variables`)
    are the port's modules (as `models.teachers`' loaders give them); None
    turns their loss to 0, as in the JAX package;
  * draws come from a `torch.Generator`, not a JAX key, so the two
    packages draw different numbers; `train_step` and the losses accept the
    draws as tensors (`draws=`) so that a test can hand over the JAX
    package's;
  * only the parameters that train require gradients: sub-encoders that
    `optimize_*` leaves off take no Adam state and no weight gradient;
  * `reconstruct` runs the system's own generator (the JAX package passes
    its variables) with a torch.Generator or injected draws (`draws=`) in
    place of the key.

Data parallel (`smirk_tpu_torch.parallel`): with a process group, each
rank passes its rows of the global batch to `train_step` / `eval_step`,
and the step computes the one-process step on the global batch: every loss
term is the rank's share of the global one, the gradients are summed across
ranks before the clip and Adam, train-mode batch norm uses the global
statistics, every rank draws the global batch's draws and keeps its rows
(the cycle path augments the gathered rows), and the metrics are the
global batch's. Without a group nothing issues a collective.

Every entry point (`infer`, `train_step`, `eval_step`, `masked_input`,
`reconstruct`, `make_visualizations`) runs its convolutions in exact fp32
(`device.fp32_math`), whatever the process's global TF32 flags say.
`infer_body`, `masked_body` and `reconstruct_body` are the bodies of
`infer`, `masked_input` and `reconstruct` without their pins, on every draw
given (`reconstruct_draws`); the served artifacts trace them
(`smirk_tpu_torch.serving`), so they cannot drift from the in-process path.

`train_step` and `infer` open a `utils.profiling.span` at each layer
boundary (`profiling.SPANS`: the phases, encoders, teachers, FLAME, the
render, masking, the augmentation, the generator, the losses, the backward,
Adam, the read-back); they are recorded only while the torch profiler
records.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import functools
import math
import threading
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from smirk_tpu_torch import parallel
from smirk_tpu_torch.config import Config
from smirk_tpu_torch.device import fp32_math, resolve_device
from smirk_tpu_torch.flame.model import FlameModel
from smirk_tpu_torch.losses.losses import (
    landmark_mse, masked_landmark_mse, param_regularization,
)
from smirk_tpu_torch.masking import masking as masking_lib
from smirk_tpu_torch.models.emoca_resnet import emotion_embedding_distance
from smirk_tpu_torch.models.encoders import SmirkEncoder
from smirk_tpu_torch.models.generator import SmirkGenerator
from smirk_tpu_torch.models.mobilenetv3 import ARCHS, Stage, frozen_stats
from smirk_tpu_torch.models.teachers import freeze
from smirk_tpu_torch.models.vgg import perceptual_loss, resize_bilinear
from smirk_tpu_torch.render import geometry
from smirk_tpu_torch.render import rasterizer as raster_lib
from smirk_tpu_torch.render.renderer import Renderer
from smirk_tpu_torch.utils.profiling import span

SUB_ENCODERS = ("pose_encoder", "shape_encoder", "expression_encoder")
# infer's CUDA graphs a system holds, the least recently used dropped past
# it: a caller's batch size and its short last batch, and a few more
INFER_GRAPHS = 4
# the masks' random hint-drop rates: path 1's and the cycle path's
RANDOM_MASK, CYCLE_RANDOM_MASK = 0.01, 0.005


def cosine_epoch_restart(peak: float, steps_per_epoch: int, eta_min_frac: float = 0.01):
    """torch CosineAnnealingLR(T_max=steps per epoch), restarted every
    epoch: step -> learning rate."""
    eta_min = eta_min_frac * peak

    def sched(step: int) -> float:
        t = step % steps_per_epoch
        cos = 0.5 * (1.0 + math.cos(math.pi * t / steps_per_epoch))
        return eta_min + (peak - eta_min) * cos

    return sched


def adam(params: Sequence[torch.Tensor], b1: float = 0.9, b2: float = 0.999):
    """optax.scale_by_adam followed by the descent p -= lr * update (torch's
    Adam is the same formula: eps added to the bias-corrected square root);
    the learning rate is set at every step from the schedule. None when
    nothing trains."""
    params = list(params)
    if not params:
        return None
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=1e-8, foreach=True)


def adam_step(opt: Optional[torch.optim.Adam], grads: Sequence[torch.Tensor],
              lr: float) -> None:
    """One Adam update of opt's parameters with the given gradients at lr."""
    if opt is None:
        return
    group = opt.param_groups[0]
    for p, g in zip(group["params"], grads):
        p.grad = g
    group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """grads * min(1, max_norm / max(||grads||, 1e-12)), the global norm
    over all tensors (the JAX package's generator clip; not
    clip_grad_norm_, which divides by norm + 1e-6)."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = (max_norm / norm.clamp_min(1e-12)).clamp(max=1.0)
    return torch._foreach_mul(grads, scale)


def augment_draws(n: int, D: int, n_templates: int, n_eyelid: int,
                  generator: Optional[torch.Generator], device) -> Dict[str, torch.Tensor]:
    """The random draws of `_augment_feats` for n rows of D expression
    components, q = n // 4 rows per group (group 3 takes the rest)."""
    q = n // 4
    r = n - 3 * q

    def uni(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {
        "perm": torch.randperm(n, generator=generator, device=device),
        "pm": torch.bernoulli(torch.full((q, D), 0.5, device=device), generator=generator),
        "noise0": nrm(q, D), "scale0": uni(q, 1),
        "jitter_scale0": uni(q, 1), "jitter0": nrm(q, D),
        "inner": torch.randperm(q, generator=generator, device=device),
        "scale1": uni(q, 1), "jitter_scale1": uni(q, 1), "jitter1": nrm(q, D),
        "tidx": torch.randint(0, n_templates, (q,), generator=generator, device=device),
        "scale2": uni(q, 1), "jitter_scale2": uni(q, 1), "jitter2": nrm(q, D),
        "jaw_mask": torch.bernoulli(torch.full((n, 1), 0.5, device=device),
                                    generator=generator),
        "jaw_noise": nrm(n, 3),
        "eyelid_u": uni(n, n_eyelid),
        "jitter_scale3": uni(r, 1), "jitter3": nrm(r, D),
        "eyelid3": uni(r, n_eyelid),
    }


def point_budget(rsing: torch.Tensor, rscale: torch.Tensor, n_upper: int,
                 mul: float) -> torch.Tensor:
    """The reconstruct path's per-image point budget: int(n_upper / mul *
    r ** rsing), r = rscale * (mul - 1) + 1, in float32 as the JAX package
    computes it. rsing (B,) +-1, rscale (B,) uniform draws in [0, 1) ->
    (B,) int32. r ** -1 is taken as the correctly rounded 1 / r: that
    gives the JAX package's budget for every float32 draw in [0, 1)
    (torch.pow misses it on two of them)."""
    r = rscale.to(torch.float32) * (mul - 1) + 1
    p = torch.where(rsing > 0, r, torch.reciprocal(r))
    return ((n_upper / mul) * p).to(torch.int32)


class _no_param_grad:
    """Within the block the module's parameters require no gradient (a
    frozen module that still passes gradients to its input)."""

    def __init__(self, module: torch.nn.Module):
        self.params = [p for p in module.parameters() if p.requires_grad]

    def __enter__(self):
        for p in self.params:
            p.requires_grad_(False)

    def __exit__(self, *exc):
        for p in self.params:
            p.requires_grad_(True)


def remat(fn):
    """fn under torch.utils.checkpoint (non-reentrant): its activations are
    recomputed in the backward. The recomputation runs inside
    `frozen_stats()`, so train-mode batch norm moves its running
    statistics once, in the first forward."""
    @functools.wraps(fn)
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), frozen_stats()))

    return run


class InferGraphs:
    """`SmirkSystem.infer`'s CUDA graphs of `infer_body`, one per key (the
    input's shape, dtype and device, the modules, the render's settings),
    at most INFER_GRAPHS, all in one private memory pool. A key's first
    call runs the body eagerly on a side stream (its answer, and the
    warm-up), then captures it there; each later call copies its input into
    the graph's, replays it and returns clones of the graph's outputs. The
    pool is taken anew whenever no graph holds it (`graphs` may be cleared
    to drop them all). One lock holds a call from the input's copy to the
    clones, and the next call's stream waits for them, so that no two
    calls share the buffers.

    Counters, plain attributes as the kernels' `launches` (each call counts
    once): `captures`, the first calls of a key; `replays`, the later ones;
    `eager`, calls on any other device (unlocked: threads calling at once
    may lose a count). `capture_s`: the host seconds of the captures,
    warm-ups apart. The kernels' own `launches` count what runs: a
    capture's recordings are taken back out of them, and each replay adds
    its graph's recorded launches.

    No CUDA work is done before the first call on a CUDA device."""

    def __init__(self):
        self.graphs = collections.OrderedDict()  # key -> (graph, input, outputs, launches)
        self.lock = threading.Lock()
        self.pool = self.stream = self.done = None
        self.captures = self.replays = self.eager = 0
        self.capture_s = 0.0

    def __call__(self, system: "SmirkSystem", img: torch.Tensor) -> Dict[str, torch.Tensor]:
        key = (img.shape, img.dtype, img.device, system.compute_dtype, system.encoder,
               system.flame, system.renderer, system.renderer.inference_settings())
        with self.lock:
            if self.stream is None:
                self.stream = torch.cuda.Stream(img.device)
                self.done = torch.cuda.Event()
            if not self.graphs:
                # a pool whose graphs are all gone (dropped, or a failed
                # capture) may not be captured into again
                self.pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.current_stream(img.device)
            stream.wait_event(self.done)
            entry = self.graphs.get(key)
            if entry is None:
                with span("smirk.infer.capture"):
                    out = self._capture(system, img, key)
                self.captures += 1
            else:
                self.graphs.move_to_end(key)
                graph, static_img, static_out, launches = entry
                with span("smirk.infer.replay"):
                    static_img.copy_(img)
                    graph.replay()
                    out = {k: v.clone() for k, v in static_out.items()}
                for kernel, n in launches:
                    kernel.launches += n
                self.replays += 1
            self.done.record(stream)
            return out

    def _capture(self, system, img, key):
        system.encoder.eval()
        caller, side = torch.cuda.current_stream(img.device), self.stream
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            static_img = torch.empty(img.shape, dtype=img.dtype, device=img.device)
            static_img.copy_(img)
            out = system.infer_body(static_img)
            t0 = time.perf_counter()
            before = [kernel.launches for kernel in raster_lib.KERNELS]
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                static_out = system.infer_body(static_img)
            finally:
                graph.capture_end()
                launches = [(kernel, kernel.launches - n)
                            for kernel, n in zip(raster_lib.KERNELS, before)
                            if kernel.launches != n]
                for kernel, n in launches:  # recorded, not run
                    kernel.launches -= n
        caller.wait_stream(side)
        for v in out.values():
            v.record_stream(caller)
        self.graphs[key] = (graph, static_img, static_out, launches)
        while len(self.graphs) > INFER_GRAPHS:
            self.graphs.popitem(last=False)
        self.capture_s += time.perf_counter() - t0
        return out


class SmirkSystem:
    """Module bundle + the training step and the serving path.

    backbone_stages maps backbone names (the config's `arch.backbone_*`) to
    stage tables; names not in it are looked up in `mobilenetv3.ARCHS`.
    The encoder and the generator start from a seeded random init; load
    trained weights with their `load_state_dict`. The teachers are None or
    the port's `VGG16Features` / `EmocaResNet50` / `Mica` (as
    `models.teachers` loads them), kept frozen in eval mode; templates (T, >=
    n_exp) are the FaMoS expression templates, zeros when None.
    `compute_dtype` (bf16 under `arch.bf16_compute`, else None = fp32) is
    the encoder's and the generator's everywhere; `frozen_dtype` (bf16
    under either flag) is the cycle path's frozen applies'. The render's
    inputs are fp32 in every mode. training=False builds a system that only
    serves (`Predictor`, the demos): it keeps no frozen base-encoder copy,
    so the base-model regularization and `make_visualizations` raise.
    """

    def __init__(
        self,
        config: Config,
        bundle: Dict[str, np.ndarray],
        *,
        device: Optional[str] = None,
        raster_compact: Optional[int] = None,
        backbone_stages: Optional[Mapping[str, Sequence[Stage]]] = None,
        steps_per_epoch: int = 1000,
        vgg_variables=None,
        emotion_variables=None,
        mica_variables=None,
        templates: Optional[np.ndarray] = None,
        generator_features: int = 32,
        generator_res_blocks: int = 5,
        training: bool = True,
    ):
        self.device = resolve_device(device)
        self.config = config
        c = config
        self.compute_dtype = torch.bfloat16 if c.arch.bf16_compute else None
        self.frozen_dtype = (torch.bfloat16 if c.arch.bf16_compute or c.arch.bf16_cycle_frozen
                             else None)
        self.vgg = freeze(vgg_variables, self.device)
        self.emotion = freeze(emotion_variables, self.device)
        self.mica = freeze(mica_variables, self.device)
        tables = dict(ARCHS, **(backbone_stages or {}))
        self.flame = FlameModel(bundle, n_shape=c.arch.num_shape,
                                n_exp=c.arch.num_expression, device=self.device)
        self.renderer = Renderer(bundle, render_full_head=c.render.full_head,
                                 image_size=c.image_size,
                                 raster_compact=raster_compact,
                                 device=self.device)
        self.encoder = SmirkEncoder(
            n_exp=c.arch.num_expression,
            n_shape=c.arch.num_shape,
            pose_stages=tables[c.arch.backbone_pose],
            shape_stages=tables[c.arch.backbone_shape],
            expression_stages=tables[c.arch.backbone_expression],
        ).init_weights(torch.Generator().manual_seed(0)).to(self.device)
        self.generator = (
            SmirkGenerator(in_channels=6, out_channels=3,
                           init_features=generator_features,
                           res_blocks=generator_res_blocks)
            .init_weights(torch.Generator().manual_seed(1))
            .to(self.device).eval()
            if c.arch.enable_fuse_generator else None)

        def to_dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.face_probabilities = to_dev(bundle["face_probabilities"], torch.float32)
        faces = np.asarray(bundle["faces"])
        fidx, cidx = geometry.build_vertex_face_incidence(faces, int(faces.max()) + 1)
        self.flame_incidence = (to_dev(fidx, torch.long), to_dev(cidx, torch.long))
        if templates is None:
            templates = np.zeros((1, c.arch.num_expression), np.float32)
        self.templates = to_dev(np.asarray(templates)[:, :c.arch.num_expression],
                                torch.float32)
        self.num_mask_points = int(c.train.mask_ratio * c.image_size ** 2)
        # the frozen copy of the initial encoder (the JAX package's
        # TrainState.base_encoder): the regularization pulls toward it with
        # use_base_model_for_regularization; the visualizations render it
        self.base_encoder = (copy.deepcopy(self.encoder).eval().requires_grad_(False)
                             if training else None)

        # --- optimizers: only the sub-encoders optimize_* enables ---
        flags = {"pose_encoder": c.train.optimize_pose,
                 "shape_encoder": c.train.optimize_shape,
                 "expression_encoder": c.train.optimize_expression}
        for name in SUB_ENCODERS:
            getattr(self.encoder, name).requires_grad_(flags[name])
        self.enc_params = [p for name in SUB_ENCODERS if flags[name]
                           for p in getattr(self.encoder, name).parameters()]
        self.enc_opt = adam(self.enc_params)
        self.enc_lr = cosine_epoch_restart(0.25 * c.train.lr, steps_per_epoch)
        self.gen_params = (list(self.generator.parameters())
                           if self.generator is not None else [])
        self.gen_opt = adam(self.gen_params, b1=0.5, b2=0.999)
        self.gen_lr = cosine_epoch_restart(c.train.lr, steps_per_epoch)
        self.step = 0
        self.infer_graphs = InferGraphs()  # infer's CUDA graphs, none yet

    # ------------------------------- helpers -------------------------------

    def _batch(self, batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        """Batch dict (numpy or tensors) -> tensors on the device."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                device=self.device)
            out[k] = t if t.dtype == torch.bool else t.to(torch.float32)
        return out

    def _base_encoder(self) -> torch.nn.Module:
        if self.base_encoder is None:
            raise ValueError("this system was built with training=False and keeps no "
                             "base encoder")
        return self.base_encoder.eval()

    def _cycle_enabled(self) -> bool:
        return (self.config.train.loss_weights.cycle_loss > 0
                and self.generator is not None)

    def _eval_mode(self) -> None:
        self.encoder.eval()
        if self.generator is not None:
            self.generator.eval()

    def _rank_draws(self, draws: Mapping[str, object], b: int, groups: int,
                    random_mask: float, generator: Optional[torch.Generator]):
        """The mesh sampler's and the mask's draws of a path, drawn here
        for the global batch of W x b rows (W = 1 without a process group)
        wherever `draws` (the global batch's) lacks them, in the order the
        path has always drawn them: the sampler's `u` and `bary` (W x b
        rows; none with `coords`), then the mask's `noise` and
        `drop_centers` (groups x W x b rows, at `random_mask`). -> this
        rank's rows of each (`parallel.local_rows`; all of them without a
        group)."""
        d = dict(draws)
        n, S, N = parallel.world_size() * b, self.config.image_size, self.num_mask_points
        dev = self.device
        if "coords" not in d:
            if "u" not in d:
                d["u"] = torch.rand((n, N), generator=generator, device=dev)
            if "bary" not in d:
                d["bary"] = masking_lib.random_barycentric((n, N), generator, dev)
        if "noise" not in d:
            d["noise"] = torch.randn((groups * n, S, S, 3), generator=generator, device=dev)
        if "drop_centers" not in d:
            d["drop_centers"] = torch.bernoulli(
                torch.full((groups * n, S, S, 1), random_mask, device=dev), generator=generator)
        out = {k: parallel.local_rows(d[k]) for k in ("u", "bary") if k in d}
        out.update((k, parallel.local_rows(d[k], groups)) for k in ("noise", "drop_centers"))
        if "coords" in d:
            out["coords"] = {k: parallel.local_rows(v) for k, v in d["coords"].items()}
        return out

    # ------------------------------- path 1 -------------------------------

    def _loss1(self, batch, train: bool, generator: Optional[torch.Generator] = None,
               draws: Optional[Mapping[str, object]] = None):
        """First path: landmarks + regularization + masked reconstruction.
        -> (total loss, aux). draws: optional `coords` (or `u`, `bary`),
        `noise`, `drop_centers` for the mesh sampling and the mask."""
        c = self.config
        w = c.train.loss_weights
        draws = draws or {}
        img = batch["img"]
        B = img.shape[0]
        share = parallel.share

        self.encoder.train(train)
        with span("smirk.encoder"):
            enc_out = self.encoder(img, self.compute_dtype)
        with span("smirk.flame"):
            flame_out = self.flame(enc_out)
        with span("smirk.render"):
            rend = self.renderer(
                flame_out["vertices"], enc_out["cam"],
                {"landmarks_fan": flame_out["landmarks_fan"],
                 "landmarks_mp": flame_out["landmarks_mp"]},
                # no generator: no image-space loss, the render is for viewing
                inference=self.generator is None,
            )
        base_out = mica_shape = None
        if c.train.use_base_model_for_regularization:
            with torch.no_grad(), span("smirk.teacher"):
                base_out = self._base_encoder()(img, self.compute_dtype)
        if self.mica is not None and w.mica_loss > 0:
            with torch.no_grad(), span("smirk.teacher"):
                mica_shape = self.mica(batch["img_mica"])[..., :c.arch.num_shape]

        recon_img = masked_img = emotion = None
        if self.generator is not None:
            with span("smirk.masking"):
                draws = self._rank_draws(draws, B, 1, RANDOM_MASK, generator)
                npoints, _ = masking_lib.sample_mesh_points(
                    rend["transformed_vertices"].detach(), self.flame.faces,
                    self.face_probabilities, self.num_mask_points, c.image_size,
                    coords=draws.get("coords"), incidence=self.flame_incidence,
                    generator=generator, u=draws.get("u"), bary=draws.get("bary"))
                extra = masking_lib.transfer_pixels(img, npoints, npoints)
                masked_img = masking_lib.compose_mask(
                    img, batch["mask"], extra,
                    dilation_radius=c.train.mask_dilation_radius,
                    rendered_mask=rend["rendered_mask"], random_mask=RANDOM_MASK,
                    generator=generator, noise=draws.get("noise"),
                    drop_centers=draws.get("drop_centers"))
                gen_in = torch.cat([rend["rendered_img"], masked_img], dim=-1)
            if self.emotion is not None and w.emotion_loss > 0:
                # the generator re-applied with its parameters detached and
                # eval-mode batch norm on a copy of the running statistics
                # as they stand before this step's train-mode forward moves
                # them in place (the backward reads the copy); the gradient
                # still reaches the encoder through gen_in
                with span("smirk.losses"):
                    self.generator.eval()
                    frozen_gen = {n: p.detach() for n, p in self.generator.named_parameters()}
                    frozen_gen.update((n, b.clone()) for n, b in self.generator.named_buffers())
                    recon_p = functional_call(self.generator, frozen_gen,
                                              (gen_in, self.compute_dtype))
                    emotion = share(emotion_embedding_distance(self.emotion, recon_p, img,
                                                               metric="l2").mean())
            self.generator.train(train)
            with span("smirk.generator"):
                recon_img = self.generator(gen_in, self.compute_dtype)

        with span("smirk.losses"):
            zero = img.new_zeros(())
            losses = {}
            # monitoring only: max compact chunks dropped past the budget; > 0
            # means some tiles rendered EMPTY with zero gradients
            losses["raster_overflow"] = rend["raster_overflow"].max().to(torch.float32)
            flags = batch["flag_landmarks_fan"]
            losses["landmark_loss_fan"] = masked_landmark_mse(
                rend["landmarks_fan"], batch["landmarks_fan"][..., :2], flags,
                count=(parallel.all_sum(flags.to(torch.float32).sum())
                       if parallel.active() else None))
            losses["landmark_loss_mp"] = share(landmark_mse(
                rend["landmarks_mp"], batch["landmarks_mp"][..., :2]))
            if base_out is None:
                base_out = {
                    "expression_params": img.new_zeros((B, c.arch.num_expression)),
                    "shape_params": img.new_zeros((B, c.arch.num_shape)),
                    "jaw_params": img.new_zeros((B, 3)),
                }
            for k in ("expression", "shape", "jaw"):
                losses[f"{k}_regularization"] = share(param_regularization(
                    enc_out[f"{k}_params"], base_out[f"{k}_params"]))

            rec_err = None
            if recon_img is not None:
                rec_err = (recon_img - img).abs()
                losses["reconstruction_loss"] = share(rec_err.mean())
                losses["perceptual_vgg_loss"] = (
                    share(perceptual_loss(self.vgg, recon_img, img))
                    if self.vgg is not None and w.perceptual_vgg_loss > 0 else zero)
                losses["emotion_loss"] = zero if emotion is None else emotion
            else:
                losses["reconstruction_loss"] = zero
                losses["perceptual_vgg_loss"] = zero
                losses["emotion_loss"] = zero
            losses["mica_loss"] = (
                zero if mica_shape is None
                else share(((enc_out["shape_params"] - mica_shape) ** 2).mean()))

            shape_losses = (losses["shape_regularization"] * w.shape_regularization
                            + losses["mica_loss"] * w.mica_loss)
            expression_losses = (
                losses["expression_regularization"] * w.expression_regularization
                + losses["jaw_regularization"] * w.jaw_regularization)
            landmark_losses = (losses["landmark_loss_fan"]
                               + losses["landmark_loss_mp"]) * w.landmark_loss
            fuse_losses = (losses["perceptual_vgg_loss"] * w.perceptual_vgg_loss
                           + losses["reconstruction_loss"] * w.reconstruction_loss
                           + losses["emotion_loss"] * w.emotion_loss)
            total = landmark_losses
            if c.train.optimize_shape:
                total = total + shape_losses
            if c.train.optimize_expression:
                total = total + expression_losses
            if self.generator is not None:
                total = total + fuse_losses

        def det(x):
            return None if x is None else x.detach()

        aux = {
            "losses": losses,
            "encoder_output": {k: v.detach() for k, v in enc_out.items()},
            "transformed_vertices": rend["transformed_vertices"].detach(),
            "rendered_img": rend["rendered_img"].detach(),
            "masked_img": masked_img,
            "reconstructed_img": det(recon_img),
            "loss_img": None if rec_err is None else rec_err.detach().mean(-1, keepdim=True),
            "landmarks_fan": rend["landmarks_fan"].detach(),
            "landmarks_mp": rend["landmarks_mp"].detach(),
        }
        return total, aux

    # ------------------------------- path 2 -------------------------------

    def _augment_feats(self, feats: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Mapping[str, torch.Tensor]] = None):
        """Parameter augmentation of the cycle path: a random permutation
        splits the rows into 4 groups of q = n // 4 (the last takes the
        rest): random expressions, a scaled batch permutation, template
        injection, and zero expression with random eyelids; jaw and eyelid
        jitter for every row. draws: as `augment_draws` returns them."""
        c = self.config
        expr = feats["expression_params"].clone()
        n, D = expr.shape
        q = n // 4
        eyelid = feats["eyelid_params"]
        d = draws if draws is not None else augment_draws(
            n, D, self.templates.shape[0], eyelid.shape[1], generator, expr.device)
        perm = d["perm"].long()
        g0, g1, g2, g3 = perm[:q], perm[q:2 * q], perm[2 * q:3 * q], perm[3 * q:]

        new0 = d["noise0"] * (1 + 2 * d["scale0"]) * d["pm"] + expr[g0]
        expr[g0] = new0.clamp(-4.0, 4.0) + 0.2 * d["jitter_scale0"] * d["jitter0"]
        expr[g1] = ((0.25 + 1.25 * d["scale1"]) * expr[g1][d["inner"].long()]
                    + 0.2 * d["jitter_scale1"] * d["jitter1"])
        expr[g2] = ((0.25 + 1.25 * d["scale2"]) * self.templates[d["tidx"].long()]
                    + 0.2 * d["jitter_scale2"] * d["jitter2"])

        scale_mask = expr.new_tensor([[1.0, 0.1, 0.1]]) * d["jaw_mask"]
        jaw = feats["jaw_params"] + d["jaw_noise"] * 0.2 * scale_mask
        jaw = torch.cat([jaw[:, :1].clamp(0.0, 0.5), jaw[:, 1:]], dim=1)
        if c.arch.use_eyelids:
            eyelid = (eyelid + (-1 + 2 * d["eyelid_u"]) * 0.25).clamp(0.0, 1.0)

        expr[g3] = 0.2 * d["jitter_scale3"] * d["jitter3"]
        jaw[g3] = 0.0
        if c.arch.use_eyelids:
            eyelid = eyelid.clone()
            eyelid[g3] = d["eyelid3"]

        out = dict(feats)
        out["expression_params"] = expr
        out["jaw_params"] = jaw
        out["eyelid_params"] = eyelid
        return {k: v.detach() for k, v in out.items()}

    def _loss2(self, batch, enc_out, trans_verts, freeze_encoder: bool,
               freeze_generator: bool, generator: Optional[torch.Generator] = None,
               draws: Optional[Mapping[str, object]] = None):
        """Cycle path -> (total loss, aux). draws: optional `augment` (see
        `augment_draws`), `coords` (or `u`, `bary`), `noise`,
        `drop_centers`."""
        c = self.config
        draws = draws or {}
        img = batch["img"]
        Ke = c.train.Ke

        # the augmentation permutes rows across the global batch: with a
        # process group it runs on every rank's rows, each rank keeping its
        # own of the result
        with span("smirk.augment"):
            rows = {k: v.detach() for k, v in enc_out.items()}
            if parallel.active():
                rows = parallel.all_gather_rows(rows)
            feats = {k: torch.cat([v] * Ke, dim=0) for k, v in rows.items()}
            feats = self._augment_feats(feats, generator, draws.get("augment"))
            feats = {k: parallel.local_rows(v, Ke) for k, v in feats.items()}

        # the augmented parameters' render carries no gradient: the fused
        # inference raster
        with torch.no_grad():
            with span("smirk.flame"):
                flame2 = self.flame(feats)
            with span("smirk.render"):
                rend2 = self.renderer(flame2["vertices"], feats["cam"], inference=True)
        rendered_img_2nd = rend2["rendered_img"]

        with span("smirk.masking"):
            draws = self._rank_draws(draws, img.shape[0], Ke, CYCLE_RANDOM_MASK, generator)
            points1, coords = masking_lib.sample_mesh_points(
                trans_verts, self.flame.faces, self.face_probabilities,
                self.num_mask_points, c.image_size, coords=draws.get("coords"),
                incidence=self.flame_incidence, generator=generator,
                u=draws.get("u"), bary=draws.get("bary"))
            coords = {k: torch.cat([v] * Ke, dim=0) for k, v in coords.items()}
            points2, _ = masking_lib.sample_mesh_points(
                rend2["transformed_vertices"], self.flame.faces,
                self.face_probabilities, self.num_mask_points, c.image_size,
                coords=coords)
            img_k = torch.cat([img] * Ke, dim=0)
            extra = masking_lib.transfer_pixels(img_k, torch.cat([points1] * Ke, dim=0),
                                                points2)
            masked_img_2nd = masking_lib.compose_mask(
                img_k, torch.cat([batch["mask"]] * Ke, dim=0), extra,
                dilation_radius=c.train.mask_dilation_radius,
                rendered_mask=rend2["rendered_mask"], extra_noise=True,
                random_mask=CYCLE_RANDOM_MASK, generator=generator, noise=draws.get("noise"),
                drop_centers=draws.get("drop_centers"))
            gen_in = torch.cat([rendered_img_2nd, masked_img_2nd], dim=-1).detach()

        # the frozen module runs at frozen_dtype, the training one at
        # compute_dtype; train.remat_cycle recomputes the four applies in
        # the backward (each sets its module's mode itself, since the
        # recomputation runs then)
        wrap = remat if c.train.remat_cycle else (lambda f: f)

        def generator_frozen(x):
            self.generator.eval()
            return self.generator(x, self.frozen_dtype)

        def generator_train(x):
            self.generator.train()
            return self.generator(x, self.compute_dtype)

        def encoder_frozen(x):
            # eval-mode batch norm and no weight gradient, but the gradient
            # flows through it back to the generator via `recon`
            self.encoder.eval()
            with _no_param_grad(self.encoder):
                return self.encoder(x, self.frozen_dtype)

        def encoder_train(x):
            self.encoder.train()
            return self.encoder(x, self.compute_dtype)

        with span("smirk.generator"):
            if freeze_generator:
                with torch.no_grad():
                    recon = wrap(generator_frozen)(gen_in)
            else:
                recon = wrap(generator_train)(gen_in)
        with span("smirk.encoder"):
            recon_feats = wrap(encoder_frozen if freeze_encoder else encoder_train)(recon)

        with span("smirk.losses"):
            cycle = (landmark_mse(recon_feats["expression_params"], feats["expression_params"])
                     + 10.0 * landmark_mse(recon_feats["jaw_params"], feats["jaw_params"]))
            if c.arch.use_eyelids:
                cycle = cycle + 10.0 * landmark_mse(recon_feats["eyelid_params"],
                                                    feats["eyelid_params"])
            if not freeze_generator:
                cycle = cycle + landmark_mse(recon_feats["shape_params"],
                                             feats["shape_params"])
            cycle = parallel.share(cycle)
            total = cycle * c.train.loss_weights.cycle_loss
            overflow_2nd = rend2["raster_overflow"].max().to(torch.float32)
        aux = {
            "losses": {
                "cycle_loss": cycle,
                "raster_overflow_2nd": overflow_2nd,
            },
            "viz": {
                "rendered_img_2nd": rendered_img_2nd,
                "masked_img_2nd": masked_img_2nd,
                "reconstructed_img_2nd": recon.detach(),
                "recon_feats": {k: v.detach() for k, v in recon_feats.items()},
            },
        }
        return total, aux

    # ------------------------------ full step ------------------------------

    @staticmethod
    def _grads(total, params):
        """d total / d params (zeros where unused), summed across ranks in a
        data-parallel step."""
        with span("smirk.backward"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
            return parallel.all_reduce_grads(
                [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])

    def _phase1(self, batch, generator=None, draws=None):
        """Path-1 gradients + both Adam steps -> (metrics, aux)."""
        with span("smirk.phase1"):
            loss1, aux = self._loss1(batch, True, generator, draws)
            self._update_path1(loss1)
            metrics = dict(aux["losses"])
            metrics["loss_first_path"] = loss1.detach()
            return metrics, aux

    def _update_path1(self, loss1) -> None:
        """Path 1's backward and both Adam steps at the iteration's rates."""
        grads = self._grads(loss1, self.enc_params + self.gen_params)
        n_enc = len(self.enc_params)
        with span("smirk.adam"):
            adam_step(self.enc_opt, grads[:n_enc], self.enc_lr(self.step))
            adam_step(self.gen_opt, grads[n_enc:], self.gen_lr(self.step))

    def _phase2(self, batch, enc_out, trans_verts, parity: int,
                generator=None, draws=None):
        """Cycle-path gradients + the unfrozen module's Adam step, on the
        phase-1-updated parameters, at the iteration's learning rate."""
        freeze_encoder = parity % 2 == 0
        with span("smirk.phase2"):
            loss2, aux = self._loss2(batch, enc_out, trans_verts, freeze_encoder,
                                     not freeze_encoder, generator, draws)
            if not freeze_encoder:
                grads = self._grads(loss2, self.enc_params)
                with span("smirk.adam"):
                    adam_step(self.enc_opt, grads, self.enc_lr(self.step))
            else:
                grads = self._grads(loss2, self.gen_params)
                with span("smirk.adam"):
                    adam_step(self.gen_opt, clip_by_global_norm(grads, 0.1),
                              self.gen_lr(self.step))
            metrics = dict(aux["losses"])
            metrics["loss_second_path"] = loss2.detach()
            return metrics, aux["viz"]

    @staticmethod
    def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """-> {name: float}, of the global batch in a data-parallel step:
        the ranks' shares summed, the raster overflow (a max over images)
        maximized, in one collective."""
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().to(torch.float32) for k in keys])
        values = parallel.reduce_metrics(values, [k.startswith("raster_overflow")
                                                  for k in keys])
        return dict(zip(keys, values.tolist()))

    @fp32_math()
    def train_step(self, batch, parity: int, generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Mapping[str, object]]] = None):
        """One training iteration -> (metrics {name: float}, aux).

        batch: img (B,S,S,3) in [0,1], landmarks_fan (B,68,2+),
        flag_landmarks_fan (B,) bool, landmarks_mp (B,105,2+), mask
        (B,S,S,1) with 1 = background (numpy or tensors). parity: even
        freezes the encoder in the cycle path, odd the generator.
        generator: the torch.Generator of every draw (on the system's
        device); None = one seeded with the step counter. draws: optional
        {"path1": ..., "path2": ...} tensors for `_loss1` / `_loss2`. In a
        data-parallel step the batch is this rank's rows (every rank as
        many), the generator is seeded alike on every rank and the draws
        given are the global batch's.
        """
        with span("smirk.train_step"):
            with span("smirk.batch"):
                batch = self._batch(batch)
            draws = draws or {}
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.step)
            try:
                metrics, aux = self._phase1(batch, generator, draws.get("path1"))
                if self._cycle_enabled():
                    metrics2, viz2 = self._phase2(
                        batch, aux["encoder_output"], aux["transformed_vertices"],
                        parity, generator, draws.get("path2"))
                    metrics.update(metrics2)
                    aux["second_path"] = viz2
            finally:
                self._eval_mode()
            self.step += 1
            with span("smirk.readback"):
                return self._floats(metrics), aux

    @fp32_math()
    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator] = None,
                  draws: Optional[Mapping[str, object]] = None):
        """Path 1 in eval mode, no update -> (losses {name: float}, aux)."""
        batch = self._batch(batch)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.step)
        try:
            _, aux = self._loss1(batch, False, generator, draws)
        finally:
            self._eval_mode()
        return self._floats(aux["losses"]), aux

    # ------------------------------ inference ------------------------------

    @fp32_math()
    @torch.inference_mode()
    def infer(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B,S,S,3) f32 NHWC images in [0,1] -> params + geometry + render,
        fresh tensors.

        The renderer's 2D projected `landmarks_fan`/`landmarks_mp` replace
        FLAME's 3D ones in the result, as in the JAX package. The encoder
        runs in eval mode. On a CUDA device the call replays a CUDA graph
        of `infer_body` captured, in eval mode, at the first call of its
        input shape (`InferGraphs`); a replay leaves the encoder's mode as
        it is (setting it walks the encoder's 332 submodules, ~1.7 ms of
        host time). Parameters and buffers changed in place (an
        optimizer's step, `load_state_dict`) show in a replay; a module
        replaced on the system, or a render setting changed, captures anew;
        a module moved or cast in place (`.to`, `.half`) does not. Other
        devices run the body eagerly."""
        with span("smirk.infer"):
            img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
            if img.device.type == "cuda":
                return self.infer_graphs(self, img)
            self.encoder.eval()
            self.infer_graphs.eager += 1
            return self.infer_body(img)

    def infer_body(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`infer` without its pins and conversions: the encoder (in the mode
        it is in), FLAME and the inference render. The served artifacts
        trace this body (`serving.make_inference_fn`), so that they run what
        `infer` runs."""
        with span("smirk.encoder"):
            enc_out = self.encoder(img, self.compute_dtype)
        with span("smirk.flame"):
            flame_out = self.flame(enc_out)
        with span("smirk.render"):
            rend = self.renderer(
                flame_out["vertices"], enc_out["cam"],
                {"landmarks_fan": flame_out["landmarks_fan"],
                 "landmarks_mp": flame_out["landmarks_mp"]},
                inference=True,
            )
        return {**enc_out, **flame_out, **rend}

    def _reconstruct_budget(self):
        """(n_upper, mul): the sampled points and the budget's spread."""
        c, S = self.config, self.config.image_size
        mul = float(c.train.mask_ratio_mul)
        return int(float(c.train.mask_ratio) * mul * S * S), mul

    def reconstruct_draws(self, batch: int, generator: Optional[torch.Generator] = None,
                          draws: Optional[Mapping[str, torch.Tensor]] = None):
        """The draws of `masked_input` for `batch` images
        (`masking.reconstruct_draws` at this config's n_upper and size), in
        its order; those in `draws` are taken as given."""
        n_upper, _ = self._reconstruct_budget()
        return masking_lib.reconstruct_draws(batch, n_upper, self.config.image_size,
                                             generator, self.device, given=draws)

    @fp32_math()
    @torch.inference_mode()
    def masked_input(self, infer_out: Mapping[str, torch.Tensor], img, hull,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """The generator's masked input of `reconstruct`: n_upper = mask_ratio
        x mask_ratio_mul x S^2 mesh points sampled on infer's transformed
        vertices, the first `point_budget` of them per image copied as
        pixel hints, the hull-masked image with noisy hints and 11x11
        dropout (compose_mask, extra noise, random mask 0.01, the config's
        dilation radius) -> (B,S,S,3).

        draws: optional tensors in place of `generator`'s draws: `u` and
        `bary` (or `coords`) for the sampler, `rsing` (B,) +-1 and `rscale`
        (B,) in [0, 1) for the budget, `noise` and `drop_centers` for the
        mask (`reconstruct_draws` draws the others)."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        hull = torch.as_tensor(hull, dtype=torch.float32, device=self.device)
        return self.masked_body(infer_out, img, hull,
                                self.reconstruct_draws(img.shape[0], generator, draws))

    def masked_body(self, infer_out: Mapping[str, torch.Tensor], img: torch.Tensor,
                    hull: torch.Tensor, draws: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """`masked_input` without its pins, on every draw given
        (`reconstruct_draws`)."""
        c = self.config
        n_upper, mul = self._reconstruct_budget()
        npoints, _ = masking_lib.sample_mesh_points(
            infer_out["transformed_vertices"], self.flame.faces,
            self.face_probabilities, n_upper, c.image_size,
            coords=draws.get("coords"), incidence=self.flame_incidence,
            u=draws.get("u"), bary=draws.get("bary"))
        extra = masking_lib.transfer_pixels(
            img, npoints, npoints,
            valid_count=point_budget(draws["rsing"], draws["rscale"], n_upper, mul))
        return masking_lib.compose_mask(
            img, hull, extra, dilation_radius=c.train.mask_dilation_radius,
            rendered_mask=infer_out["rendered_mask"], extra_noise=True,
            random_mask=masking_lib.RECONSTRUCT_RANDOM_MASK, noise=draws["noise"],
            drop_centers=draws["drop_centers"])

    @fp32_math()
    @torch.inference_mode()
    def reconstruct(self, infer_out: Mapping[str, torch.Tensor], img, hull,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Mapping[str, torch.Tensor]] = None):
        """Analysis-by-neural-synthesis reconstruction from `infer`'s
        outputs: the fuse generator (eval mode) on [render | masked input]
        (`masked_input`). img (B,S,S,3) in [0,1]; hull (B,S,S,1) with 1 =
        background. -> (masked_img, reconstructed_img)."""
        if self.generator is None:
            raise ValueError("reconstruct needs the fuse generator "
                             "(arch.enable_fuse_generator)")
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        hull = torch.as_tensor(hull, dtype=torch.float32, device=self.device)
        self.generator.eval()
        return self.reconstruct_body(infer_out, img, hull,
                                     self.reconstruct_draws(img.shape[0], generator, draws))

    def reconstruct_body(self, infer_out: Mapping[str, torch.Tensor], img: torch.Tensor,
                         hull: torch.Tensor, draws: Mapping[str, torch.Tensor]):
        """`reconstruct` without its pins, on every draw given: the served
        reconstruct artifact traces it (`serving.make_reconstruct_fn`)."""
        masked = self.masked_body(infer_out, img, hull, draws)
        recon = self.generator(torch.cat([infer_out["rendered_img"], masked], dim=-1),
                               self.compute_dtype)
        return masked, recon

    # ---------------------------- visualization ----------------------------

    @fp32_math()
    @torch.inference_mode()
    def make_visualizations(self, batch, aux) -> Dict[str, Optional[torch.Tensor]]:
        """The training panels that `utils.viz.training_grid` lays out
        (the JAX package's `make_visualizations`): the step's render,
        masked input, reconstruction, loss map and landmarks from `aux`
        (`train_step` / `eval_step`), plus the base encoder's render, the
        zero-pose / zero-expression render (cam [7, 0, 0]) and, after a
        cycle step, the cycle path's '2nd_path' stack: for each sample, Ke
        groups of [augmented render | masked | reconstruction | re-render
        of the re-encoded parameters]. With the MICA teacher and an
        `img_mica` in the batch, also the zero-pose render of MICA's shape
        and the 112 px crop resized to the model's size. Every render is
        the fused inference raster."""
        img = self._batch({"img": batch["img"]})["img"]
        B = img.shape[0]
        enc_out = aux["encoder_output"]
        zero_cam = img.new_tensor([[7.0, 0.0, 0.0]]).expand(B, 3)
        viz = {k: aux.get(k) for k in ("rendered_img", "masked_img", "reconstructed_img",
                                       "loss_img", "landmarks_fan", "landmarks_mp")}
        base_out = self._base_encoder()(img, self.compute_dtype)
        viz["rendered_img_base"] = self.renderer(
            self.flame(base_out)["vertices"], base_out["cam"], inference=True)["rendered_img"]
        zero_flame = self.flame(enc_out, zero_expression=True, zero_pose=True)
        viz["rendered_img_zero"] = self.renderer(
            zero_flame["vertices"], zero_cam, inference=True)["rendered_img"]
        if self.mica is not None and "img_mica" in batch:
            img_mica = self._batch({"img_mica": batch["img_mica"]})["img_mica"]
            mica_out = dict(enc_out)
            mica_out["shape_params"] = self.mica(img_mica)[..., :self.config.arch.num_shape]
            mica_flame = self.flame(mica_out, zero_expression=True, zero_pose=True)
            viz["rendered_img_mica_zero"] = self.renderer(
                mica_flame["vertices"], zero_cam, inference=True)["rendered_img"]
            viz["img_mica"] = resize_bilinear(img_mica, self.config.image_size)
        sp = aux.get("second_path")
        if sp is not None:
            recon_feats = sp["recon_feats"]
            rerender = self.renderer(self.flame(recon_feats)["vertices"], recon_feats["cam"],
                                     inference=True)["rendered_img"]
            KeB, H, W, C = rerender.shape
            Ke = KeB // B
            panels = [sp["rendered_img_2nd"], sp["masked_img_2nd"],
                      sp["reconstructed_img_2nd"], rerender]
            # (Ke*B, ...) k-major -> (B, Ke, 4, H, W, C) -> (B*Ke*4, ...)
            stack = torch.stack([p.reshape(Ke, B, H, W, C).transpose(0, 1) for p in panels], 2)
            viz["2nd_path"] = stack.reshape(B * Ke * 4, H, W, C)
        return viz
