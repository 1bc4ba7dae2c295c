"""The program's spans (`smirk_tpu_torch.utils.profiling.span`) on the CPU.

Without a profiler no span reaches the profiler's op; under
`torch.profiler` a train step of each parity and an infer call open
exactly the span tree of `profiling.SPANS`, each span nested in its
parent; an exported serving program holds no profiler op, with the
profiler on or off. Tiny backbones, 32 px, batch 2: the recipe with the
generator and the cycle path, and one without the generator whose teacher
is the base encoder (the shape of the pretrain recipe's step).
"""
import collections
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smirk_tpu_torch import serving
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils import profiling
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
STAGES = {"tf_mobilenetv3_small_minimal_100": TINY_SMALL,
          "tf_mobilenetv3_large_minimal_100": TINY_LARGE}
S, B = 32, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = dict(perceptual_vgg_loss=0.0, emotion_loss=0.0, mica_loss=0.0)
RECIPES = {
    "cycle": dict(arch=dict(), train=dict()),
    "no_generator": dict(arch=dict(enable_fuse_generator=False),
                         train=dict(use_base_model_for_regularization=True)),
}

RENDER = [("smirk.render", "smirk.render.bin")]
PHASE1 = {
    "cycle": ["encoder", "flame", "render", "masking", "generator", "losses",
              "backward", "adam"],
    "no_generator": ["encoder", "flame", "render", "teacher", "losses", "backward",
                     "adam"],
}
PHASE2 = ["augment", "flame", "render", "masking", "generator", "encoder", "losses",
          "backward", "adam"]


def expected_step(recipe):
    """(parent, name) of every span one train_step opens (the root's
    parent None)."""
    edges = [(None, "smirk.train_step"), ("smirk.train_step", "smirk.batch"),
             ("smirk.train_step", "smirk.phase1"), ("smirk.train_step", "smirk.readback")]
    phases = [("smirk.phase1", PHASE1[recipe])]
    if recipe == "cycle":
        edges.append(("smirk.train_step", "smirk.phase2"))
        phases.append(("smirk.phase2", PHASE2))
    for phase, names in phases:
        edges += [(phase, "smirk." + n) for n in names]
        edges += RENDER
    return collections.Counter(edges)


EXPECTED_INFER = collections.Counter(
    [(None, "smirk.infer"), ("smirk.infer", "smirk.encoder"),
     ("smirk.infer", "smirk.flame"), ("smirk.infer", "smirk.render")] + RENDER)


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=5, full_size=False)


def make_system(bundle, recipe):
    r = RECIPES[recipe]
    cfg = Config(image_size=S, arch=ArchConfig(num_expression=10, num_shape=30, **r["arch"]),
                 train=TrainConfig(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3,
                                   Ke=1, loss_weights=LossWeights(**WEIGHTS), **r["train"]))
    return SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES, steps_per_epoch=10,
                       generator_features=8, generator_res_blocks=1)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.arange(B) % 4 != 1,
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
    }


def calls(system):
    """A train step of each parity, then an infer call."""
    system.train_step(make_batch(0), 0)
    system.train_step(make_batch(1), 1)
    system.infer(make_batch(2)["img"])


def span_edges(events):
    """(parent, name) of each `smirk.*` range, the parent the shortest
    other range that holds it (None for a root), by interval nesting."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("smirk.")]
    edges = []
    for s in spans:
        holders = [o for o in spans if o is not s and o[0] <= s[0] and s[1] <= o[1]]
        parent = min(holders, key=lambda o: o[1] - o[0])[2] if holders else None
        edges.append((s[0], parent, s[2]))
    return spans, edges


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_no_profiler_op_without_a_profiler(bundle, recipe, monkeypatch):
    """With no profiler running, train steps of both parities and an infer
    call never call the profiler's record_function op for a span (torch's
    Optimizer opens its own ranges, ungated, on every step and zero_grad)."""
    system = make_system(bundle, recipe)
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def count(*args):
        entered.append(args[0])
        return real(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", count)
    calls(system)
    assert [n for n in entered if n.startswith("smirk.")] == []
    with profile(activities=[ProfilerActivity.CPU]):  # the patch sees a span
        with profiling.span("smirk.infer"):
            pass
    assert entered[-1] == "smirk.infer"


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_span_tree(bundle, recipe, tmp_path):
    """Under torch.profiler, each call opens exactly the spans of its tree:
    every span nested in its parent, each name as often as the tree has
    it; the CPU's infer opens neither of the CUDA graph's spans."""
    system = make_system(bundle, recipe)
    calls(system)  # warm: first-use set-up outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls(system)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, edges = span_edges(events)
    roots = sorted((s for s in spans if s[2] in ("smirk.train_step", "smirk.infer")),
                   key=lambda s: s[0])
    assert [r[2] for r in roots] == ["smirk.train_step"] * 2 + ["smirk.infer"]
    for root, want in zip(roots, [expected_step(recipe)] * 2 + [EXPECTED_INFER]):
        got = collections.Counter((p, n) for t, p, n in edges
                                  if root[0] <= t <= root[1])
        assert got == want, root
    assert {n for _, _, n in spans} <= set(profiling.SPANS)
    graphed = {"smirk.infer.capture", "smirk.infer.replay"}
    assert graphed <= set(profiling.SPANS)
    assert not graphed & {n for _, _, n in spans}  # the CPU's infer runs eagerly


def test_export_holds_no_profiler_op(bundle, tmp_path):
    """The program serving exports from infer_body holds no profiler node,
    exported with the profiler on and with it off; span() is the no-op
    while export traces, whatever the profiler's state."""
    system = make_system(bundle, "no_generator")
    for on in (False, True):
        path = str(tmp_path / f"infer_{on}")
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                path = serving.export_inference(system, path, batch_size=B)
        else:
            path = serving.export_inference(system, path, batch_size=B)
        targets = [str(n.target) for n in torch.export.load(path).graph.nodes
                   if n.op == "call_function"]
        assert targets and not [t for t in targets
                                if "profiler" in t or "record_function" in t], on

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(profiling.span("smirk.infer"))
            return x + 1

    with profile(activities=[ProfilerActivity.CPU]):
        torch.export.export(Probe(), (torch.ones(2),), strict=False)
        seen.append(profiling.span("smirk.infer"))
    assert seen[0] is profiling.span("smirk.infer")  # the shared no-op
    assert isinstance(seen[-1], torch.profiler.record_function)


def test_span_names_are_the_list():
    """Every span the program opens is named in SPANS, and every name in
    SPANS is opened somewhere."""
    pattern = re.compile(r"""\bspan\(\s*["']([^"']+)["']""")
    used = set()
    for root, _, files in os.walk(os.path.join(REPO, "smirk_tpu_torch")):
        for name in files:
            if name.endswith(".py") and name != "profiling.py":
                with open(os.path.join(root, name)) as f:
                    used |= set(pattern.findall(f.read()))
    assert used == set(profiling.SPANS)
    assert all(n.startswith("smirk.") for n in profiling.SPANS)
