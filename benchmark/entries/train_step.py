"""Entry: back-to-back `SmirkSystem.train_step` calls, the freeze parity
alternating step by step as cli.train does, on the pool's batches with
their draws (item i % pool at step i).

Set-up builds the one system the window drives and runs its first steps
through the window's own call, on distinct batches; those are the
checked steps. The first step's losses, the optimizers' first gradient
(worked out from Adam's first moment after its first update, m / (1 -
beta1)) and, after the last checked step, each trained leaf's change are
read then. After the window the reference follows the checked steps from
the same weights, batches and draws.

The change is compared per optimizer (the encoders' and the generator's),
each leaf against its own optimizer's median leaf, so that an update
that goes wrong in one optimizer alone shows; the cell's file says which
leaf of each ("change": "worst" or "median") and which steps' losses
("losses": "first" or "every"). Why the median and the first step's
losses where the cycle path runs: leaves whose gradient is zero up to
rounding (a batch-norm bias followed by a train-mode batch norm) move by
+-lr under Adam on the sign of their rounding, which differs between any
two orders of summation; the cycle path runs the encoder in eval mode,
so the next batch norm's running statistics carry that move, and the
later steps' losses and the worst leaf's change of two sound runs drift
apart by a few percent.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from benchmark import compare, loadgen, program, roofline, weights
from benchmark.reference.system import ReferenceSystem, precision


def worst(prog, ref, keep=None, n=6, group=None):
    """The n leaves of the largest gaps among `keep` (each against the
    median leaf of `group`, default all): [name, gap, program's norm,
    reference's norm], and that median leaf's reference norm."""
    group = list(ref if group is None else group)
    keys = list(group if keep is None else keep)
    gaps = compare.group_gaps(prog, ref, group, keys)
    rows = sorted(zip(gaps, keys), reverse=True)[:n]
    return {"median_ref": statistics.median(ref[k] for k in group),
            "median_gap": statistics.median(gaps) if gaps else None,
            "leaves": [[k, g, prog.get(k), ref[k]] for g, k in rows]}


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.spec = ctx.cfg, ctx.traffic
        self.images_per_call = self.spec["batch"]
        self.checked = self.spec["checked_steps"]
        self.n = 0
        self.failed = 0

    # ------------------------------ set-up ------------------------------

    def setup(self) -> None:
        ctx, dev = self.ctx, self.ctx.device
        self.weights = weights.make(self.cfg, ctx.seed, dev)
        self.pool = loadgen.make_pool(self.spec, self.cfg, ctx.seed, dev)
        if ctx.control:
            self._setup_control()
            return
        self.system = program.system(self.cfg, ctx.bundle, self.weights, dev)
        s = self.system
        names = [f"{sub}.{n}" for sub in ("pose_encoder", "shape_encoder", "expression_encoder")
                 if getattr(s.config.train, "optimize_" + sub.split("_")[0])
                 for n, _ in getattr(s.encoder, sub).named_parameters()]
        if s.generator is not None:
            names += [n for n, _ in s.generator.named_parameters()]
        params = s.enc_params + s.gen_params
        if len(names) != len(params):
            raise RuntimeError("the trained leaves do not match the optimizers' parameters")
        self.names = dict(zip(map(id, params), names))
        start = {self.names[id(p)]: p.detach().clone() for p in params}
        first: Dict[str, float] = {}

        def hook(opt, args, kwargs):
            b1 = opt.param_groups[0]["betas"][0]
            for p in opt.param_groups[0]["params"]:
                name = self.names[id(p)]
                if name not in first:
                    first[name] = float((opt.state[p]["exp_avg"].double() / (1 - b1)).norm())

        handles = [o.register_step_post_hook(hook) for o in (s.enc_opt, s.gen_opt)
                   if o is not None]
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.losses = []
        for _ in range(self.checked):
            self.losses += self._step()
        for h in handles:
            h.remove()
        self.first_grads = first
        self.changes = {self.names[id(p)]: float((p.detach() - start[self.names[id(p)]])
                                                 .double().norm()) for p in params}
        del start

    def _setup_control(self) -> None:
        """The reference in the program's place, with TF32 on."""
        ref = ReferenceSystem(self.cfg, self.ctx.bundle, self.weights, self.ctx.device,
                              program.steps_per_epoch(self.cfg))
        start = {k: v.clone() for k, v in ref.trained().items()}
        self.losses, self.first_grads = [], None
        with precision(tf32=True):
            for i in range(self.checked):
                item = self.pool[i % len(self.pool)]
                out = ref.train_step(item["batch"], i % 2, item["draws"])
                self.losses += out["losses"]
                if self.first_grads is None:
                    self.first_grads = compare.norms(out["grads"])
        self.changes = compare.norms({k: v - start[k] for k, v in ref.trained().items()})
        self.system = None

    # ------------------------------ the window ------------------------------

    def _step(self):
        item = self.pool[self.n % len(self.pool)]
        metrics, _ = self.system.train_step(item["batch"], self.n % 2, self.gen,
                                            draws=item["draws"])
        torch.cuda.synchronize() if self.ctx.device.type == "cuda" else None
        self.n += 1
        if not all(math.isfinite(v) for v in metrics.values()):
            self.failed += 1
        return [metrics[k] for k in ("loss_first_path", "loss_second_path") if k in metrics]

    def call(self) -> int:
        self._step()
        return self.images_per_call

    # ------------------------------ the check ------------------------------

    def release(self) -> None:
        self.system = None
        del self.pool[self.checked:]
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict:
        """-> {"numbers": {name: value}, "record": {...}} against the
        reference's checked steps."""
        cfg, dev = self.cfg, self.ctx.device
        ref = ReferenceSystem(cfg, self.ctx.bundle, self.weights, dev,
                              program.steps_per_epoch(cfg))
        start = {k: v.clone() for k, v in ref.trained().items()}
        losses, grads, flops, faces, coverage = [], None, [], [], None
        for i in range(self.checked):
            item = self.pool[i]
            with precision(tf32=False):
                out, f = roofline.model_flops(
                    lambda: ref.train_step(item["batch"], i % 2, item["draws"]))
            losses += out["losses"]
            flops.append(f)
            faces.append(out["face_verts"])
            if grads is None:
                grads = compare.norms(out["grads"])
                coverage = out["coverage"]
        changes = compare.norms({k: v - start[k] for k, v in ref.trained().items()})
        spec = self.ctx.spec
        n = len(losses) // self.checked if spec["losses"] == "first" else len(losses)
        numbers = {
            "loss_gap": compare.loss_gap(self.losses[:n], losses[:n]),
            "grad_gap": max(compare.leaf_gaps(self.first_grads, grads)),
        }
        pick = max if spec["change"] == "worst" else statistics.median
        moved, change_leaves = [], {}
        for group, named in (("encoder", ref.enc_named), ("generator", ref.gen_named)):
            leaves = [k for k, _ in named]
            if not leaves:
                continue
            keep = compare.moved_leaves({k: grads[k] for k in leaves})
            gaps = compare.group_gaps(self.changes, changes, leaves, keep)
            numbers["change_gap." + group] = pick(gaps) if gaps else float("inf")
            moved += keep
            change_leaves[group] = worst(self.changes, changes, keep, group=leaves)
        # the raster work of a step of each parity: the path-1 render
        # (differentiable, with its backward, where the generator is on)
        # and the cycle path's inference render
        S, diff = cfg["image_size"], cfg["arch"]["enable_fuse_generator"]
        bounds = []
        for step_faces in faces[:2]:
            parts = [roofline.raster_forward(fv, S, 3) for fv in step_faces]
            if diff:
                parts.append(roofline.raster_backward(step_faces[0], S, 3))
            bounds.append(roofline.total_bound(parts))
        return {"numbers": numbers, "coverage": coverage,
                "record": {"flops_per_call": sum(flops[:2]) / len(flops[:2]),
                           "raster_bound_s_per_call": sum(b[0] for b in bounds) / len(bounds),
                           "raster_bound_by": bounds[0][1],
                           "leaves_left_out": sorted(set(grads) - set(moved)),
                           "losses": [self.losses, losses],
                           "worst_grad_leaves": worst(self.first_grads, grads),
                           "worst_change_leaves": change_leaves}}
