"""`SmirkSystem.infer`'s CUDA graphs (`trainer.InferGraphs`) and the
device-resident constants they need.

On the CPU: no tensor made on the host enters the served body, FLAME's
forward or the differentiable render (each such tensor is a copy to the
card, with a sync, on every call, and cannot be captured), and infer runs
the body eagerly. On the card (`cuda` marker; skipped without one): a
replay equals the eager body under infer's pins, bitwise; each call
returns fresh tensors; weights loaded in place show in the next replay; a
new input shape, a replaced module or a changed render setting captures a
new graph, at most INFER_GRAPHS held; threads get their own outputs.

These tests import no JAX, so they run on the card's machine with:

    python -m pytest --noconftest -m cuda tests/test_torch_infer_graph.py
"""
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config
from smirk_tpu_torch.device import fp32_math
from smirk_tpu_torch.render import rasterizer
from smirk_tpu_torch.render.renderer import Renderer
from smirk_tpu_torch.train.trainer import INFER_GRAPHS, SmirkSystem
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
STAGES = {"tf_mobilenetv3_small_minimal_100": TINY_SMALL,
          "tf_mobilenetv3_large_minimal_100": TINY_LARGE}
S = 64


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=4, full_size=False)


def make_system(bundle, device):
    cfg = Config(image_size=S, arch=ArchConfig(num_shape=30, num_expression=10,
                                               enable_fuse_generator=False))
    return SmirkSystem(cfg, bundle, device=device, backbone_stages=STAGES, training=False)


def images(n, seed, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).random((n, S, S, 3), np.float32)).to(
        device)


def eager(system, img):
    """infer_body under infer's pins, eagerly."""
    with fp32_math(), torch.inference_mode():
        system.encoder.eval()
        return system.infer_body(img)


def assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


class HostMade(TorchDispatchMode):
    """Records each op that reads a tensor neither given (`known`) nor made
    by an earlier op in the mode: a tensor made from host data
    (`torch.tensor`, a numpy index, a scalar written into a 0-d view)."""

    def __init__(self, known):
        super().__init__()
        self.known = {t.untyped_storage().data_ptr() for t in known}
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for a in tree_flatten((args, kwargs or {}))[0]:
            if (isinstance(a, torch.Tensor) and a.numel()
                    and a.untyped_storage().data_ptr() not in self.known):
                self.found.append((str(func), tuple(a.shape)))
        out = func(*args, **(kwargs or {}))
        self.known |= {o.untyped_storage().data_ptr() for o in tree_flatten(out)[0]
                       if isinstance(o, torch.Tensor) and o.numel()}
        return out


@pytest.mark.parametrize("path", ["infer_body", "flame", "render"])
def test_no_host_made_tensor_enters(bundle, path):
    """The served body (encoders, FLAME, the inference render), FLAME's
    forward and the training path's differentiable render read only their
    inputs, the modules' parameters and buffers, and what their own ops
    make."""
    system = make_system(bundle, "cpu")
    img = images(2, 0)
    modules = (system.encoder, system.flame, system.renderer)
    known = [t for m in modules for t in list(m.parameters()) + list(m.buffers())]
    enc = {k: v.detach() for k, v in eager(system, img).items()}
    enc = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in enc.items()}
    calls = {
        "infer_body": ([img], lambda: eager(system, img)),
        "flame": (list(enc.values()), lambda: system.flame(enc)),
        "render": ([enc["vertices"], enc["cam"]],
                   lambda: system.renderer(enc["vertices"], enc["cam"], inference=False)),
    }
    given, call = calls[path]
    probe = HostMade(known + given)
    with probe:
        out = call()
    assert out and probe.found == []


def run_threads(n, fn):
    """fn(i) in n threads at once, the interpreter switching every 10 us;
    -> each thread's exception, None where it raised none."""
    errors = [None] * n

    def run(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 (returned to the test)
            errors[i] = e

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    return errors


def test_cpu_infer_runs_the_body_eagerly(bundle):
    """Off the card infer counts eager calls, captures nothing, makes no
    pool and returns the body's outputs."""
    system = make_system(bundle, "cpu")
    for seed in (1, 2):
        img = images(2, seed)
        assert_equal(system.infer(img), eager(system, img))
    graphs = system.infer_graphs
    assert (graphs.eager, graphs.captures, graphs.replays) == (2, 0, 0)
    assert not graphs.graphs and graphs.pool is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replays_match_the_eager_body(bundle, card):
    """Each batch size captures once and replays after, every call equal to
    the eager body bitwise, with the process's TF32 flags on too, and K1's
    count rising by one a call, capture or replay; past INFER_GRAPHS sizes
    the least recently used graph goes and its size captures again."""
    system = make_system(bundle, card)
    graphs = system.infer_graphs
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            for b in (3, 2):
                for seed in (b, b + 10):
                    img = images(b, seed, card)
                    rasterizer.reset_launch_counts()
                    got = system.infer(img)
                    assert rasterizer.raster_fused_windows.launches == 1
                    assert_equal(got, eager(system, img))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert (graphs.captures, graphs.replays, graphs.eager) == (2, 6, 0)
    for b in (1, 4, 5, 6):
        system.infer(images(b, b, card))
    assert len(graphs.graphs) == INFER_GRAPHS == 4 and graphs.captures == 6
    img = images(3, 7, card)  # b3, the least recently used, went first
    assert_equal(system.infer(img), eager(system, img))
    assert (graphs.captures, graphs.replays) == (7, 6) and graphs.capture_s > 0


@pytest.mark.cuda
def test_outputs_are_fresh_and_weights_show(bundle, card):
    """A call's outputs stay as they were through later calls; weights
    loaded in place show in the next replay, which answers in eval mode
    with the encoder in train mode; a replaced renderer, a changed render
    setting or binning mode captures anew, as does a call after every graph
    was dropped."""
    system = make_system(bundle, card)
    graphs = system.infer_graphs
    a, b = images(2, 1, card), images(2, 2, card)
    system.infer(a)
    first = system.infer(a)
    kept = {k: v.clone() for k, v in first.items()}
    system.infer(b)
    assert_equal(first, kept)

    state = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point() else v
             for k, v in system.encoder.state_dict().items()}
    system.encoder.load_state_dict(state)
    after = system.infer(a)
    assert_equal(after, eager(system, a))
    assert not torch.equal(after["expression_params"], kept["expression_params"])
    assert (graphs.captures, graphs.replays) == (1, 3)
    want = eager(system, a)
    system.encoder.train()  # a replay answers in eval mode all the same
    assert_equal(system.infer(a), want)

    system.renderer.bin_miss_check_fused = not system.renderer.bin_miss_check_fused
    assert_equal(system.infer(a), eager(system, a))
    system.renderer = Renderer(bundle, image_size=S, device=card)
    assert_equal(system.infer(a), eager(system, a))
    assert (graphs.captures, graphs.replays) == (3, 4)
    try:
        rasterizer.set_bin_mode(True)
        assert_equal(system.infer(a), eager(system, a))
        assert_equal(system.infer(a), eager(system, a))
    finally:
        rasterizer.set_bin_mode(False)
    system.infer(a)
    assert (graphs.captures, graphs.replays) == (4, 6)
    graphs.graphs.clear()  # every graph dropped: the next capture takes a new pool
    assert_equal(system.infer(a), eager(system, a))
    assert_equal(system.infer(a), eager(system, a))
    assert (graphs.captures, graphs.replays) == (5, 7)


@pytest.mark.cuda
def test_threads_get_their_own_outputs(bundle, card):
    """Twelve threads calling infer at once on one shape (more threads than
    an 8-core host has cores) each get the outputs of their own images, and
    no replay goes uncounted."""
    system = make_system(bundle, card)
    inputs = [images(2, 100 + i, card) for i in range(12)]
    want = [eager(system, img) for img in inputs]
    system.infer(inputs[0])
    got = [[] for _ in inputs]

    def calls(i):
        for _ in range(3):
            out = system.infer(inputs[i])
            torch.cuda.current_stream().synchronize()
            got[i].append(out)

    errors = run_threads(len(inputs), calls)
    assert not any(errors), errors
    for outs, ref in zip(got, want):
        assert len(outs) == 3
        for out in outs:
            assert_equal(out, ref)
    assert system.infer_graphs.replays == 36
