"""Entry: one caller sending back-to-back `SmirkSystem.infer` calls on
the pool's device-resident batches (item i % pool at call i), each call
ended by a synchronize, as every served path waits for its outputs.

A seeded reservoir keeps the outputs of `sample` calls drawn evenly from
all the window's calls; after the window the reference computes each
kept call's batch again and is compared with what the call returned.
"""
from __future__ import annotations

import random
from typing import Dict

import torch

from benchmark import compare, loadgen, program, roofline, weights
from benchmark.reference.system import ReferenceSystem, precision

PARAMS = ("pose_params", "cam", "shape_params", "expression_params", "eyelid_params",
          "jaw_params")
GEOMETRY = ("vertices", "transformed_vertices", "landmarks_fan", "landmarks_mp")


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.spec = ctx.cfg, ctx.traffic
        self.images_per_call = self.spec["batch"]
        self.n = 0
        self.failed = 0
        self.kept = []  # [(call index, pool item, outputs)]
        self.rng = random.Random(ctx.seed)

    def setup(self) -> None:
        ctx, dev = self.ctx, self.ctx.device
        self.weights = weights.make(self.cfg, ctx.seed, dev, teachers=())
        self.pool = loadgen.make_pool(self.spec, self.cfg, ctx.seed, dev)
        if ctx.control:
            ref = ReferenceSystem(self.cfg, ctx.bundle, self.weights, dev,
                                  program.steps_per_epoch(self.cfg))

            def control(img):
                with precision(tf32=True):
                    return ref.infer(img)

            self.infer = control
        else:
            self.infer = program.system(self.cfg, ctx.bundle, self.weights, dev,
                                        training=False).infer
        for item in self.pool[:2]:  # every shape the window uses
            self.infer(item["img"])
        self._sync()

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self) -> int:
        item = self.n % len(self.pool)
        out = self.infer(self.pool[item]["img"])
        self._sync()
        k = self.spec["sample"]
        slot = len(self.kept) if len(self.kept) < k else self.rng.randrange(self.n + 1)
        if slot < k:
            kept = {key: out[key].clone() for key in PARAMS + GEOMETRY
                    + ("rendered_img", "rendered_mask")}
            if slot == len(self.kept):
                self.kept.append((self.n, item, kept))
            else:
                self.kept[slot] = (self.n, item, kept)
        self.n += 1
        return self.images_per_call

    def release(self) -> None:
        self.infer = None
        keep = {item for _, item, _ in self.kept}
        self.pool = {i: self.pool[i] for i in keep}
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict:
        ref = ReferenceSystem(self.cfg, self.ctx.bundle, self.weights, self.ctx.device,
                              program.steps_per_epoch(self.cfg))
        gaps = {"params_gap": 0.0, "geometry_gap": 0.0, "render_gap": 0.0}
        flops, bounds, coverage = [], [], 1.0
        for _, item, got in self.kept:
            with precision(tf32=False):
                want, f = roofline.model_flops(lambda: ref.infer(self.pool[item]["img"]))
            flops.append(f)
            gaps["params_gap"] = max([gaps["params_gap"]] + [
                compare.max_gap(got[k], want[k]) for k in PARAMS])
            gaps["geometry_gap"] = max([gaps["geometry_gap"]] + [
                compare.max_gap(got[k], want[k]) for k in GEOMETRY])
            gaps["render_gap"] = max(gaps["render_gap"],
                                     compare.mean_gap(got["rendered_img"], want["rendered_img"]))
            coverage = min(coverage, float(got["rendered_mask"].mean()))
            bounds.append(roofline.total_bound(
                [roofline.raster_forward(want["face_verts"], self.cfg["image_size"], 3)]))
        if not self.kept:
            gaps = {k: float("inf") for k in gaps}
        return {"numbers": gaps, "coverage": coverage,
                "record": {"flops_per_call": sum(flops) / max(1, len(flops)),
                           "raster_bound_s_per_call": sum(b[0] for b in bounds)
                           / max(1, len(bounds)),
                           "raster_bound_by": bounds[0][1] if bounds else None,
                           "sampled_calls": sorted(i for i, _, _ in self.kept)}}
