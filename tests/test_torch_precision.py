"""PyTorch port vs the JAX package: the compute dtype (`arch.bf16_compute`,
`arch.bf16_cycle_frozen`) and `train.remat_cycle`.

Both packages run tiny backbones at 64 px, batch 2, the generator at 8
features / 1 ResNet block, on one procedural bundle and one set of weights
(carried by `encoder_state_dict_from_jax` / `generator_state_dict_from_jax`).
The JAX systems render through their plain reference raster
(`use_pallas=False`). A training step's draws are the JAX key's, derived in
the JAX package's split order and handed to the port (`draws=`).

The bf16 rule, per output: the port's bf16 result differs from the JAX
package's bf16 result by at most twice what the JAX package's bf16 result
differs from its own fp32 one. An output is an encoder output, the
generator's image, a loss, or a trained module after a step (its
parameters together, its running statistics together: an Adam step is
about lr * sign(g), so any element whose gradient is near 0 can flip).
Where the port's fp32 result is not JAX's to rounding (a training step:
train-mode batch norm's variance, which Flax takes as E[x^2] - E[x]^2, and
those Adam signs), twice the port's fp32 distance to the JAX package's fp32
result is added to the bound; 1e-7 is added for outputs bf16 leaves exact.
A loss is one number, so its two errors are one draw each, and twice one
draw falls short of the other about two times in five by chance alone: a
step's losses count as one output, each relative to its JAX bf16 value,
and they pass where the rule's bound on their max, or 2^-8 (bf16's unit),
holds.
The rule alone would pass a port that ignored the dtype (its fp32 result
lies about as far from the JAX bf16 one as the JAX fp32 one does), so the
forwards' outputs and the trained modules also move from the port's own
fp32 result by at least half of what the JAX package's move from theirs,
and the convolutions are watched: bf16 inputs, but for the generator's
fp32 output head.
bf16_cycle_frozen only changes the cycle path: its rule covers the cycle's
loss and the generator its step updates, and its phase 1 equals the fp32
one. remat_cycle changes no value: the port's
step with it equals the step without it bit for bit on the CPU, running
statistics included, and its losses hold the fp32 tolerance (1e-4
relative) against the JAX package's step with remat.
"""
import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu import masking as JM
from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.config import LossWeights as JaxLossWeights
from smirk_tpu.config import TrainConfig as JaxTrainConfig
from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu.train.trainer import TrainState
from smirk_tpu.utils import importer as jax_importer
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B, KE = 64, 2, 2
ARCH = dict(num_expression=10, num_shape=30)
TRAIN = dict(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3, Ke=KE)
WEIGHTS = dict(perceptual_vgg_loss=0.0, emotion_loss=0.0, mica_loss=0.0)
GEN = dict(generator_features=8, generator_res_blocks=1)
LOSS_RTOL = 1e-4
BF16_UNIT = 2.0 ** -8  # bf16's spacing relative to a value in [1, 2)
# the JAX configurations the tests compare: name -> (arch flags, train flags)
VARIANTS = {
    "fp32": ({}, {}),
    "bf16": ({"bf16_compute": True}, {}),
    "cycle_frozen": ({"bf16_cycle_frozen": True}, {}),
    "remat": ({}, {"remat_cycle": True}),
}


def t(x):
    return torch.from_numpy(np.array(x))


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.ones(B, bool),
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=5, full_size=False)


def jax_variables(module, shape, state_dict):
    """A Flax module's variables holding the port's state dict (the JAX
    package's importer; the template from jax.eval_shape, no init run)."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), dict(tree))
    return dict(jax_importer.import_state_dict(
        {k: v.numpy() for k, v in state_dict.items()}, template))


@pytest.fixture(scope="module")
def jax_env(bundle):
    """{variant: JAX system} sharing one state, tiny backbones patched in
    with a restore: the port's seeded init carried over, the encoder's
    weights then perturbed so that batch norm and the heads are
    nontrivial."""
    mp = pytest.MonkeyPatch()
    mp.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    systems = {}
    for name, (arch, train) in VARIANTS.items():
        cfg = JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH, **arch),
                        train=JaxTrainConfig(**TRAIN, **train,
                                             loss_weights=JaxLossWeights(**WEIGHTS)))
        systems[name] = JaxSmirkSystem(cfg, bundle, steps_per_epoch=10, use_pallas=False, **GEN)
    jsys = systems["fp32"]
    init = port_system(bundle, None)
    enc = jax_variables(jsys.encoder, (1, S, S, 3), init.encoder.state_dict())
    gen = jax_variables(jsys.generator, (1, S, S, 6), init.generator.state_dict())
    rng = np.random.default_rng(1)
    enc = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(np.asarray(x) + (0.05 if p[-1].key in ("scale", "bias", "mean")
                                                  else 0.01)
                                 * rng.normal(size=x.shape).astype(np.float32)), enc)
    gen = jax.tree_util.tree_map(jnp.asarray, gen)
    state = TrainState(step=jnp.zeros((), jnp.int32), encoder=enc, generator=gen,
                       base_encoder=enc, enc_opt=jsys.enc_tx.init(enc["params"]),
                       gen_opt=jsys.gen_tx.init(gen["params"]))
    yield systems, state
    mp.undo()


def port_system(bundle, jax_state, arch=None, train=None):
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH, **(arch or {})),
                 train=TrainConfig(**TRAIN, **(train or {}),
                                   loss_weights=LossWeights(**WEIGHTS)))
    system = SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES,
                         steps_per_epoch=10, **GEN)
    if jax_state is not None:
        system.encoder.load_state_dict(encoder_state_dict_from_jax(jax_state.encoder))
        system.generator.load_state_dict(generator_state_dict_from_jax(jax_state.generator))
    return system


def bf16_rule(got, want_bf16, want_fp32, what, base=None):
    """|port bf16 - JAX bf16| <= 2 |JAX bf16 - JAX fp32| + 2 |port fp32 -
    JAX fp32| + 1e-7, each side the max over the output; `base` is the
    port's fp32 result (None: the port's fp32 matches JAX's to rounding).
    -> the ratio of the left side to the right."""
    got, a, b = (np.asarray(x, np.float64) for x in (got, want_bf16, want_fp32))
    err, ref = np.abs(got - a).max(), np.abs(a - b).max()
    slack = 0.0 if base is None else np.abs(np.asarray(base, np.float64) - b).max()
    bound = 2 * ref + 2 * slack + 1e-7
    assert err <= bound, (what, err, ref, slack)
    return err / bound


def differs(got, port_fp32, want_bf16, want_fp32, what):
    """The port's bf16 result is not its fp32 one: it moves from it by at
    least half of what the JAX package's bf16 result moves from its fp32
    one (a port that ran fp32 would pass `bf16_rule` but not this)."""
    moved = np.abs(np.asarray(got, np.float64) - np.asarray(port_fp32, np.float64)).max()
    ref = np.abs(np.asarray(want_bf16, np.float64) - np.asarray(want_fp32, np.float64)).max()
    assert moved >= 0.5 * ref, (what, moved, ref)


@contextlib.contextmanager
def conv_inputs(*modules):
    """Within the block, the dtypes every convolution of `modules` is
    called with -> {'<module class>.<name>': set of dtypes}."""
    seen, hooks = {}, []
    for root in modules:
        for name, m in root.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                key = f"{type(root).__name__}.{name}"
                hooks.append(m.register_forward_pre_hook(
                    lambda _, args, key=key: seen.setdefault(key, set()).add(args[0].dtype)))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def losses_rule(got, want_bf16, want_fp32, base, keys):
    """The step's losses as one output: each relative to the JAX package's
    bf16 value, the bf16 rule on their max; they also pass within bf16's
    unit of every value. -> the ratio of the error to the bound."""
    rel = [np.array([abs(float(x[k]) - float(want_bf16[k])) / abs(float(want_bf16[k]))
                     for k in keys]) for x in (got, want_fp32, base)]
    err, ref, slack = rel[0].max(), np.abs(np.array(
        [(float(want_bf16[k]) - float(want_fp32[k])) / float(want_bf16[k]) for k in keys])).max(), \
        np.abs(np.array([(float(base[k]) - float(want_fp32[k])) / float(want_bf16[k])
                         for k in keys])).max()
    bound = max(2 * ref + 2 * slack + 1e-7, BF16_UNIT)
    assert err <= bound, (dict(zip(keys, rel[0])), ref, slack)
    return err / bound


def jax_step(systems, name, state, batch, key, parity, phase1=None):
    """The JAX package's training step in split mode (`train_step`: phase
    1's program, then the cycle's) -> numpy (state, metrics, aux1). phase1
    names the system whose phase-1 program runs: a variant that changes only
    the cycle path shares the fp32 one's."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mid, metrics, aux1 = systems[phase1 or name]._split1(state, jb, key, final=False)
    new, metrics2, _ = systems[name]._split2(mid, jb, aux1["encoder_output"],
                                             aux1["transformed_vertices"], key, parity=parity)
    return jax.tree_util.tree_map(np.asarray, (new, {**metrics, **metrics2}, aux1, mid))


def cycle_loss_on(bundle, mid, aux, batch, parity, draws, arch=None):
    """The port's cycle loss (`_loss2`) on the JAX package's state after its
    phase 1 (`mid`) and its phase-1 outputs: the cycle path alone, on the
    parameters the JAX package's cycle path saw."""
    psys = port_system(bundle, mid, arch=arch)
    with torch.no_grad():
        loss, _ = psys._loss2(psys._batch(batch), {k: t(v) for k, v in
                                                   aux["encoder_output"].items()},
                              t(aux["transformed_vertices"]), parity == 0, parity == 1,
                              draws=draws["path2"])
    return float(loss)


def step_draws(jsys, aux, key, n_templates=1):
    """The port's `train_step(draws=)` from the JAX step's key (step 0),
    the sampled points' coords on the JAX phase-1 mesh."""
    from test_torch_train import augment_draws_from_jax

    rng1, rng2 = jax.random.split(jax.random.fold_in(key, 0))
    tv = jnp.asarray(aux["transformed_vertices"])

    def coords(k):
        _, c = JM.sample_mesh_points(k, tv, jsys.flame.faces, jsys.face_probabilities,
                                     jsys.num_mask_points, S, incidence=jsys.flame_incidence)
        return {k_: t(v).long() if v.dtype == jnp.int32 else t(v) for k_, v in c.items()}

    kpts, kmask = jax.random.split(rng1)
    kn, kp = jax.random.split(kmask)
    path1 = {"coords": coords(kpts), "noise": t(jax.random.normal(kn, (B, S, S, 3))),
             "drop_centers": t(jax.random.bernoulli(kp, 0.01, (B, S, S, 1))).float()}
    k_aug, k_p1, k_mask, _ = jax.random.split(rng2, 4)
    kn, kp = jax.random.split(k_mask)
    n = KE * B
    path2 = {"augment": augment_draws_from_jax(k_aug, n, ARCH["num_expression"], n_templates),
             "coords": coords(k_p1), "noise": t(jax.random.normal(kn, (n, S, S, 3))),
             "drop_centers": t(jax.random.bernoulli(kp, 0.005, (n, S, S, 1))).float()}
    return {"path1": path1, "path2": path2}


def port_params(psys):
    """{'encoder' / 'generator' / 'stats': every parameter (or running
    statistic) of the port's modules after a step, flattened in the port's
    names' order}."""
    return modules_flat({"encoder": psys.encoder.state_dict(),
                         "generator": psys.generator.state_dict()})


def jax_params(state):
    return modules_flat({"encoder": encoder_state_dict_from_jax(state.encoder),
                         "generator": generator_state_dict_from_jax(state.generator)})


def modules_flat(sds):
    """A trained module counts as one output: its parameters (and apart,
    its running statistics) flattened together, so that the rule's max
    runs over the module, as an Adam step's sign can flip on any element
    with a gradient near 0."""
    out = {}
    for name, sd in sds.items():
        for part, keep in (("params", lambda k: "running" not in k and "num_batches" not in k),
                           ("stats", lambda k: "running" in k)):
            keys = sorted(k for k in sd if keep(k))
            out[f"{name} {part}"] = np.concatenate([sd[k].numpy().ravel() for k in keys])
    return out


def test_bf16_forwards_match_jax(bundle, jax_env):
    """The encoder (eval and train mode) and the generator (eval and train
    mode) in bf16 hold the bf16 rule on every output; the heads' outputs
    and the running statistics stay fp32; without a dtype the port's
    forward is the fp32 one."""
    systems, state = jax_env
    psys = port_system(bundle, state)
    img = make_batch(0)["img"]
    x = np.random.default_rng(2).random((B, S, S, 6)).astype(np.float32)
    apply = {(n, m, train): jax.jit(functools.partial(
        getattr(systems[n], m).apply, train=train, **({"mutable": ["batch_stats"]} if train
                                                      else {})))
        for n in ("fp32", "bf16") for m in ("encoder", "generator") for train in (False, True)}
    with torch.no_grad():
        fp32 = psys.encoder(t(img))
    want = apply["fp32", "encoder", False](state.encoder, jnp.asarray(img))
    for k, v in fp32.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    worst = 0.0
    for train in (False, True):
        outs = [apply[n, "encoder", train](state.encoder, jnp.asarray(img))
                for n in ("bf16", "fp32")]
        outs = [o[0] if train else o for o in outs]
        psys.encoder.train(train)
        with torch.no_grad():
            port32 = copy.deepcopy(psys.encoder)(t(img))
            with conv_inputs(psys.encoder) as seen:
                got = psys.encoder(t(img), torch.bfloat16)
        assert seen and all(d == {torch.bfloat16} for d in seen.values()), seen
        for k, v in got.items():
            assert v.dtype == torch.float32, k
            worst = max(worst, bf16_rule(v.numpy(), outs[0][k], outs[1][k], f"encoder {k}"))
            differs(v.numpy(), port32[k].numpy(), outs[0][k], outs[1][k], f"encoder {k}")
        gouts = [apply[n, "generator", train](state.generator, jnp.asarray(x))
                 for n in ("bf16", "fp32")]
        gouts = [o if train else (o, None) for o in gouts]
        psys.generator.train(train)
        gen32 = copy.deepcopy(psys.generator)
        with torch.no_grad():
            recon32 = gen32(t(x))
            with conv_inputs(psys.generator) as seen:
                recon = psys.generator(t(x), torch.bfloat16)
        assert seen.pop("SmirkGenerator.conv") == {torch.float32}  # the output head
        assert seen and all(d == {torch.bfloat16} for d in seen.values()), seen
        assert recon.dtype == torch.float32
        worst = max(worst, bf16_rule(recon.numpy(), gouts[0][0], gouts[1][0], "generator"))
        differs(recon.numpy(), recon32.numpy(), gouts[0][0], gouts[1][0], "generator")
        if train:  # the running statistics moved in fp32, as Flax's
            want = generator_state_dict_from_jax(
                {"params": {}, "batch_stats": gouts[0][1]["batch_stats"]})
            ref = generator_state_dict_from_jax(
                {"params": {}, "batch_stats": gouts[1][1]["batch_stats"]})
            got_sd = psys.generator.state_dict()
            keys = sorted(k for k in want if "running" in k)
            assert all(got_sd[k].dtype == torch.float32 for k in keys)
            flat = [np.concatenate([sd[k].numpy().ravel() for k in keys])
                    for sd in (got_sd, want, ref, gen32.state_dict())]
            worst = max(worst, bf16_rule(*flat[:3], "generator running statistics"))
            differs(flat[0], flat[3], flat[1], flat[2], "generator running statistics")
    assert all(p.dtype == torch.float32 for p in psys.encoder.parameters())
    print(f"worst bf16 ratio (port err / JAX bf16 err): {worst:.3g}")


@pytest.mark.parametrize("parity", [0, 1])
def test_bf16_train_step_matches_jax(bundle, jax_env, parity):
    """A bf16 training step of each parity: path 1's losses and every
    trained module after the step (parameters; running statistics) hold the
    bf16 rule, and so does the cycle loss, taken on the JAX package's
    state after its phase 1 (after an Adam step, whose signs near a zero
    gradient differ between any two bf16 runs, the two states are no
    longer one input); the render's inputs stay fp32."""
    systems, state = jax_env
    batch = make_batch(1 + parity)
    key = jax.random.PRNGKey(20 + parity)
    sb, mb, auxb, midb = jax_step(systems, "bf16", state, batch, key, parity)
    sf, mf, auxf, midf = jax_step(systems, "fp32", state, batch, key, parity)
    draws_f, draws_b = step_draws(systems["fp32"], auxf, key), step_draws(systems["bf16"], auxb, key)
    base = port_system(bundle, state)
    m_base, _ = base.train_step(batch, parity, draws=draws_f)
    psys = port_system(bundle, state, arch={"bf16_compute": True})
    seen = []
    render = psys.renderer.__class__.__call__

    def watch(self, vertices, cam, *a, **kw):
        seen.append((vertices.dtype, cam.dtype))
        return render(self, vertices, cam, *a, **kw)

    psys.renderer.__class__.__call__ = watch
    try:
        with conv_inputs(psys.encoder, psys.generator) as convs:
            metrics, _ = psys.train_step(batch, parity, draws=draws_b)
    finally:
        psys.renderer.__class__.__call__ = render
    assert seen and all(d == (torch.float32, torch.float32) for d in seen), seen
    assert convs.pop("SmirkGenerator.conv") == {torch.float32}  # the output head
    assert convs and all(d == {torch.bfloat16} for d in convs.values()), convs
    worst = losses_rule(metrics, mb, mf, m_base, (
        "loss_first_path", "landmark_loss_fan", "landmark_loss_mp", "reconstruction_loss",
        "expression_regularization"))
    cycle = {"cycle_loss": cycle_loss_on(bundle, midb, auxb, batch, parity, draws_b,
                                         {"bf16_compute": True})}
    cycle_base = {"cycle_loss": cycle_loss_on(bundle, midf, auxf, batch, parity, draws_f)}
    worst = max(worst, losses_rule(cycle, mb, mf, cycle_base, ("cycle_loss",)))
    got, want, ref, got32 = port_params(psys), jax_params(sb), jax_params(sf), port_params(base)
    assert set(got) == set(want)
    for k in want:
        worst = max(worst, bf16_rule(got[k], want[k], ref[k], k, got32[k]))
        differs(got[k], got32[k], want[k], ref[k], k)
    print(f"parity {parity}: worst bf16 ratio {worst:.3g}")


def test_bf16_cycle_frozen_matches_jax(bundle, jax_env):
    """arch.bf16_cycle_frozen at parity 0 (the frozen encoder in bf16 on the
    generator's gradient path): the cycle loss on the JAX package's state
    after phase 1 and the generator after the step (parameters; running
    statistics) hold the bf16 rule; phase 1 is the fp32 one."""
    systems, state = jax_env
    batch, key, parity = make_batch(3), jax.random.PRNGKey(30), 0
    sc, mc, aux, mid = jax_step(systems, "cycle_frozen", state, batch, key, parity,
                                phase1="fp32")
    sf, mf, _, _ = jax_step(systems, "fp32", state, batch, key, parity)
    draws = step_draws(systems["fp32"], aux, key)
    base = port_system(bundle, state)
    m_base, _ = base.train_step(batch, parity, draws=draws)
    psys = port_system(bundle, state, arch={"bf16_cycle_frozen": True})
    assert (psys.compute_dtype, psys.frozen_dtype) == (None, torch.bfloat16)
    with conv_inputs(psys.encoder) as convs:
        metrics, _ = psys.train_step(batch, parity, draws=draws)
    assert metrics["loss_first_path"] == m_base["loss_first_path"]  # phase 1 is fp32
    # phase 1's encoder in fp32, the cycle's frozen one in bf16
    assert convs and all(d == {torch.float32, torch.bfloat16} for d in convs.values()), convs
    cycle = {"cycle_loss": cycle_loss_on(bundle, mid, aux, batch, parity, draws,
                                         {"bf16_cycle_frozen": True})}
    cycle_base = {"cycle_loss": cycle_loss_on(bundle, mid, aux, batch, parity, draws)}
    worst = losses_rule(cycle, mc, mf, cycle_base, ("cycle_loss",))
    got, want, ref, got32 = port_params(psys), jax_params(sc), jax_params(sf), port_params(base)
    for k in ("generator params", "generator stats"):
        worst = max(worst, bf16_rule(got[k], want[k], ref[k], k, got32[k]))
        differs(got[k], got32[k], want[k], ref[k], k)
    print(f"cycle_frozen: worst bf16 ratio {worst:.3g}")


def test_remat_cycle_bitwise_and_matches_jax(bundle, jax_env):
    """train.remat_cycle: two steps (parity 0, then 1) equal the same steps
    without it bit for bit, the metrics, parameters, running statistics and
    Adam moments; its parity-0 step's losses hold 1e-4 against the JAX
    package's step with remat (phase 1 the fp32 system's)."""
    systems, state = jax_env
    batch = make_batch(4)
    runs = {}
    for remat in (False, True):
        psys = port_system(bundle, state, train={"remat_cycle": remat})
        gen = torch.Generator().manual_seed(0)
        metrics = [psys.train_step(batch, parity, gen)[0] for parity in (0, 1)]
        runs[remat] = psys, metrics
    (plain, m_plain), (remat, m_remat) = runs[False], runs[True]
    assert m_plain == m_remat
    for a, b in ((plain.encoder, remat.encoder), (plain.generator, remat.generator)):
        sa, sb = a.state_dict(), b.state_dict()
        assert any("running_var" in k for k in sa)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for name in ("enc_opt", "gen_opt"):
        sa, sb = (getattr(x, name).state_dict()["state"] for x in (plain, remat))
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (name, i, k)

    key, parity = jax.random.PRNGKey(40), 0
    _, mj, aux, _ = jax_step(systems, "remat", state, batch, key, parity, phase1="fp32")
    psys = port_system(bundle, state, train={"remat_cycle": True})
    metrics, _ = psys.train_step(batch, parity, draws=step_draws(systems["fp32"], aux, key))
    for k in ("loss_first_path", "loss_second_path", "cycle_loss", "reconstruction_loss",
              "landmark_loss_mp"):
        assert abs(metrics[k] - float(mj[k])) <= LOSS_RTOL * abs(float(mj[k])), (k, metrics[k],
                                                                                   mj[k])


def test_bf16_predictor_and_export(bundle, jax_env, tmp_path):
    """A system built with bf16_compute infers in bf16 (its encoder outputs
    hold the bf16 rule against the JAX package's bf16 and fp32 systems'
    `infer`), `Predictor` runs the same, and its exported inference
    artifact equals its `infer` bit for bit."""
    from smirk_tpu_torch import Predictor, serving

    systems, state = jax_env
    img = make_batch(5)["img"]
    psys = port_system(bundle, state, arch={"bf16_compute": True})
    got = psys.infer(t(img))
    want = {n: systems[n].infer(state.encoder, jnp.asarray(img)) for n in ("bf16", "fp32")}
    for k in ("pose_params", "cam", "shape_params", "expression_params", "jaw_params"):
        bf16_rule(got[k].numpy(), want["bf16"][k], want["fp32"][k], k)
    assert got["vertices"].dtype == torch.float32
    pred = Predictor(device="cpu", bundle=bundle, config=psys.config, backbone_stages=STAGES)
    pred.system.encoder.load_state_dict(psys.encoder.state_dict())
    out = pred(img)
    for k in ("expression_params", "vertices", "rendered_img"):
        np.testing.assert_array_equal(out[k], got[k].numpy(), err_msg=k)
    enc = pred.encode(img)
    np.testing.assert_array_equal(enc["expression_params"], got["expression_params"].numpy())
    path = serving.export_inference(psys, str(tmp_path / "bf16"), batch_size=B)
    served = serving.load_inference(path)(img)
    for k in ("expression_params", "vertices", "rendered_img", "rendered_mask"):
        np.testing.assert_array_equal(np.asarray(served[k]), got[k].numpy(), err_msg=k)
