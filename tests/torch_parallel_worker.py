"""A rank of the port's data-parallel step, or its one-process reference
(spawned by test_torch_parallel.py).

    python torch_parallel_worker.py RANK WORLD PORT OUT [HELD]

RANK -1 runs the reference: one process, no group, the whole global
batch, and writes the discrete parts of its steps to HELD (see below).
Otherwise the process joins a gloo group of WORLD ranks on
127.0.0.1:PORT (`parallel.initialize_distributed("cpu")`), keeps its
contiguous rows of the global batch (`parallel.shard_batch`) and reads
the reference's discrete parts from HELD. Every process runs one torch
thread. For each case and parity a fresh tiny system (seeded, its encoder
perturbed by seeded noise so that batch norm is nontrivial) takes one
`train_step`; the step's metrics, the summed gradients of every `_grads`
call, the batch-norm running statistics, the parameters after the step
and the discrete parts' differing pixel shares go to OUT (torch.save).

The discrete parts of a step are the masked images (`masking.compose_mask`
of both paths: the sampled hint pixels, the hull hole, the dropped hints)
and the cycle path's render of the augmented parameters (the inference
raster). A last-bit difference of a vertex can flip one of their pixels,
and a flipped pixel moves the generator's gradients by far more than
rounding does. So a rank computes each from its own draws and vertices,
notes the share of its pixels that differ from the reference's rows, and
goes on with the reference's rows: the gradients and statistics are then
held to the reference's at rounding's tolerance and the discrete parts
on their own.

Cases: "base" (a global batch of 4, one row without FAN labels), "denom"
(FAN labels only in rank 1's rows: the masked landmark loss's global
count) and "augment" (Ke = 2: the cycle path's parameter augmentation
with given draws whose permutation moves rows across the ranks, its inner
permutation swapping two rows of different ranks) run at learning rate 0,
so that the cycle path of both runs sees the same parameters (one Adam
step moves a parameter by about lr x sign(g), and a gradient near 0 can
flip its sign); "step" takes the default rate, parity 0 then 1 on one
system, with no part held.
"""
import os
import sys

import numpy as np
import torch

rank, world, port, out, held_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smirk_tpu_torch import parallel  # noqa: E402
from smirk_tpu_torch.assets import procedural_bundle  # noqa: E402
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig  # noqa: E402
from smirk_tpu_torch.masking import masking  # noqa: E402
from smirk_tpu_torch.models import mobilenetv3 as mnv3  # noqa: E402
from smirk_tpu_torch.train.trainer import SmirkSystem, augment_draws  # noqa: E402

BN_MOMENTUM = mnv3.BN_MOMENTUM
TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
STAGES = {"tf_mobilenetv3_small_minimal_100": TINY_SMALL,
          "tf_mobilenetv3_large_minimal_100": TINY_LARGE}
S, GB = 32, 4  # image size, global batch
# case -> Ke, learning rate, parities (each from a fresh system, or one
# system in turn)
CASES = {"base": (1, 0.0, (0, 1)), "denom": (1, 0.0, (0,)), "augment": (2, 0.0, (0, 1)),
         "step": (1, 1e-3, (0, 1))}


def make_batch(flags):
    rng = np.random.default_rng(7)
    return {
        "img": rng.random((GB, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (GB, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.asarray(flags),
        "landmarks_mp": rng.uniform(-1, 1, (GB, 105, 2)).astype(np.float32),
        "mask": (rng.random((GB, S, S, 1)) > 0.5).astype(np.float32),
    }


def make_system(bundle, Ke, lr):
    cfg = Config(image_size=S, arch=ArchConfig(num_expression=10, num_shape=30),
                 train=TrainConfig(batch_size=GB, mask_ratio=0.02, mask_dilation_radius=3,
                                   Ke=Ke, lr=lr, loss_weights=LossWeights(
                                       perceptual_vgg_loss=0.0, emotion_loss=0.0,
                                       mica_loss=0.0)))
    system = SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES,
                         steps_per_epoch=10, generator_features=8, generator_res_blocks=1)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in system.encoder.state_dict().items():
            if t.dtype.is_floating_point:
                scale = 0.05 if name.endswith(("weight", "bias", "running_mean")) else 0.01
                t.add_(scale * torch.randn(t.shape, generator=g))
        # the running statistics of a seeded batch (one train-mode forward
        # at momentum 0), so that the cycle path's eval-mode applies are
        # normalized as a trained model's are
        mnv3.BN_MOMENTUM = 0.0
        try:
            system.encoder.train()(parallel.local_rows(torch.rand((GB, S, S, 3), generator=g)))
            system.generator.train()(parallel.local_rows(torch.rand((GB, S, S, 6), generator=g)))
        finally:
            mnv3.BN_MOMENTUM = BN_MOMENTUM
    system.base_encoder.load_state_dict(system.encoder.state_dict())
    return system


def crossing_augment_draws():
    """augment_draws for n = 8 rows (Ke = 2 copies of the global batch of 4,
    q = 2) at the first seed whose group-1 rows come from both ranks and
    whose inner permutation swaps them."""
    for seed in range(1000):
        d = augment_draws(8, 10, 1, 2, torch.Generator().manual_seed(seed), "cpu")
        g1 = d["perm"][2:4] % GB
        if d["inner"].tolist() == [1, 0] and len(set((g1 // (GB // 2)).tolist())) == 2:
            return d
    raise AssertionError("no crossing permutation")


class Held:
    """The discrete parts of one step, in the order the step makes them:
    recorded (`given` None, the reference) or replaced by the reference's
    rows of each, the share of this rank's pixels that differ noted."""

    def __init__(self, given=None):
        self.given, self.taken, self.flips = given, [], []

    def __call__(self, x):
        if self.given is None:
            self.taken.append(x.detach().clone())
            return x
        ref = self.given[len(self.taken)]
        ref = parallel.local_rows(ref, ref.shape[0] // GB)
        self.taken.append(ref)
        self.flips.append(float((x != ref).any(-1).to(torch.float32).mean()))
        return ref


class HeldRenderer:
    """The system's renderer with its inference render's image held."""

    def __init__(self, renderer, held):
        self.renderer, self.held = renderer, held

    def __call__(self, *a, **k):
        out = self.renderer(*a, **k)
        if k.get("inference"):
            out = dict(out, rendered_img=self.held(out["rendered_img"]))
        return out

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def ranks_batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps):
    """F.batch_norm with a train-mode input normalized by the statistics of
    its rows as the WORLD ranks hold them (groups x WORLD x b rows, as
    `parallel.local_rows` splits them): each rank's part's two-pass moments
    (torch.var_mean), combined by the parallel-variance formula."""
    if not training:
        return batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps)
    parts = x.reshape((-1, world, GB // world) + tuple(x.shape[1:])).transpose(0, 1)
    var, mean = torch.var_mean(parts, dim=(1, 2, 4, 5), unbiased=False)  # (WORLD, C)
    g_mean = mean.mean(0)
    g_var = (var + (mean - g_mean) ** 2).mean(0)
    scale = torch.rsqrt(g_var + eps) * weight
    return (x - g_mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]


batch_norm = torch.nn.functional.batch_norm
if rank < 0:
    torch.nn.functional.batch_norm = ranks_batch_norm
else:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    assert parallel.initialize_distributed("cpu") == world

calls = []
grads_fn = SmirkSystem._grads
SmirkSystem._grads = staticmethod(
    lambda total, params: (lambda g: (calls.append([x.detach().clone() for x in g]), g)[1])(
        grads_fn(total, params)))

bundle = procedural_bundle(seed=5, full_size=False)
compose_mask = masking.compose_mask
given = {} if rank < 0 else torch.load(held_path, weights_only=False)
taken = {}
results = {}
for case, (Ke, lr, parities) in CASES.items():
    flags = [False, False, True, True] if case == "denom" else np.arange(GB) % 4 != 2
    batch = parallel.shard_batch({k: torch.from_numpy(v) for k, v in make_batch(flags).items()})
    draws = {"path2": {"augment": crossing_augment_draws()}} if case == "augment" else None
    system = None
    for parity in parities:
        if system is None or case != "step":
            system = make_system(bundle, Ke, lr)
        calls.clear()
        key = f"{case}/p{parity}"
        held = Held(None if rank < 0 else given.get(key))
        if case != "step":
            masking.compose_mask = lambda *a, **k: held(compose_mask(*a, **k))
            system.renderer = HeldRenderer(system.renderer, held)
        try:
            metrics, _ = system.train_step(batch, parity, draws=draws)
        finally:
            masking.compose_mask = compose_mask
            system.renderer = getattr(system.renderer, "renderer", system.renderer)
        taken[key] = held.taken
        modules = {"encoder": system.encoder, "generator": system.generator}
        results[key] = {
            "flips": held.flips,
            "metrics": metrics,
            "grads": [list(c) for c in calls],
            "stats": {f"{m}.{k}": v.clone() for m, mod in modules.items()
                      for k, v in mod.state_dict().items() if "running" in k},
            "params": {f"{m}.{k}": v.detach().clone() for m, mod in modules.items()
                       for k, v in mod.named_parameters()},
        }

# batch norm's statistics on their own, on a seeded input of unit scale:
# the ranks' (`parallel.global_moments`, through BatchNorm2d) against
# torch's one-process batch norm, forward and input gradient
g = torch.Generator().manual_seed(3)
x_all = 2 * torch.randn((GB, 4, 5, 5), generator=g) + 1
w_all = torch.randn(x_all.shape, generator=g)
norm = mnv3.BatchNorm2d(4)
x = parallel.local_rows(x_all).requires_grad_()
if rank < 0:
    y = batch_norm(x, None, None, norm.weight, norm.bias, True, 0.0, norm.eps)
else:
    y = norm.train()(x)
dx, = torch.autograd.grad((y * parallel.local_rows(w_all)).sum(), x)
results["moments"] = {"y": y.detach(), "dx": dx}
torch.save(results, out)
if rank < 0:
    torch.save(taken, held_path)
parallel.shutdown()
print(f"OK {rank}", flush=True)
