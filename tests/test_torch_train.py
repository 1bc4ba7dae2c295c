"""PyTorch port vs the JAX package: the training step.

Both systems are built from one procedural bundle (tiny backbones, 32 px,
batch 2, generator 8 features / 1 ResNet block) and one set of weights
(carried by `encoder_state_dict_from_jax` / `generator_state_dict_from_jax`).
The JAX system renders with its Pallas kernels in interpret mode. JAX's
draws are derived here from a JAX key in the JAX package's split order and
handed to the port, the sampled mesh points through `coords`.

Tolerances: every sub-loss within 1e-4 relative; gradients per tensor
max |diff| <= 1e-3 max |g_ref| + 1e-7 (convolution sums run in other
orders, and a render pixel at an edge tie can belong to another face);
BN running statistics 1e-5. The optimizer is checked against optax on the
same gradients (1e-6), not through post-step parameters: one Adam step is
about lr * sign(g), so a gradient near 0 can flip an update by 2 lr.

The reference gradient of the cycle path with the encoder frozen (the
generator's, back through the frozen encoder) is the JAX package's math
evaluated in float64 on the port's own generator input and targets: at 32
px the generator's train-mode batch norm normalizes 16 values per channel
at its 2x2 bottleneck, and Flax computes their variance as E[x^2] -
E[x]^2, which cancels in fp32. There JAX's fp32 gradient is ~0.3 % (up to
a few % with other weights) off its own float64 gradient, while the port's
fp32 gradient stays within ~1e-5 of it (both printed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smirk_tpu import masking as JM
from smirk_tpu.losses import landmark_mse
from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.config import LossWeights as JaxLossWeights
from smirk_tpu.config import TrainConfig as JaxTrainConfig
from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu.train.trainer import _cosine_epoch_restart
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
from smirk_tpu_torch.train.trainer import (
    SUB_ENCODERS, SmirkSystem, adam, adam_step, clip_by_global_norm,
    cosine_epoch_restart,
)
from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B, KE = 32, 2, 2
ARCH = dict(num_expression=10, num_shape=30)
TRAIN = dict(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3, Ke=KE)
WEIGHTS = dict(perceptual_vgg_loss=0.0, emotion_loss=0.0, mica_loss=0.0)
GEN = dict(generator_features=8, generator_res_blocks=1)
LOSS_RTOL = 1e-4
LOSS_KEYS = ("raster_overflow", "landmark_loss_fan", "landmark_loss_mp",
             "expression_regularization", "shape_regularization",
             "jaw_regularization", "reconstruction_loss", "perceptual_vgg_loss",
             "emotion_loss", "mica_loss")


def make_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((b, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (b, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.arange(b) % 4 != 1,
        "landmarks_mp": rng.uniform(-1, 1, (b, 105, 2)).astype(np.float32),
        "mask": (rng.random((b, S, S, 1)) > 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=5, full_size=False)


@pytest.fixture(scope="module")
def jax_system(bundle):
    """JAX system + state with tiny backbones (patched in with a restore)
    and encoder weights perturbed so batch norm and heads are nontrivial."""
    mp = pytest.MonkeyPatch()
    mp.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    cfg = JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH),
                    train=JaxTrainConfig(**TRAIN, loss_weights=JaxLossWeights(**WEIGHTS)))
    system = JaxSmirkSystem(cfg, bundle, steps_per_epoch=10, use_pallas=True, **GEN)
    state = system.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    enc = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (0.05 if p[-1].key in ("scale", "bias", "mean")
                                      else 0.01) * rng.normal(size=x.shape).astype(np.float32),
        dict(state.encoder))
    state = state.replace(encoder=jax.tree_util.tree_map(jnp.asarray, enc))
    yield system, state, mp
    mp.undo()


def port_system(bundle, jax_state, **overrides):
    train = dict(TRAIN, **{k: v for k, v in overrides.items() if k in
                           {f.name for f in dataclasses.fields(TrainConfig)}})
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH),
                 train=TrainConfig(**train, loss_weights=LossWeights(**WEIGHTS)))
    system = SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES,
                         steps_per_epoch=10, **GEN)
    system.encoder.load_state_dict(encoder_state_dict_from_jax(jax_state.encoder))
    system.generator.load_state_dict(generator_state_dict_from_jax(jax_state.generator))
    return system


def t(x):
    return torch.from_numpy(np.array(x))


def torch_named(tree):
    """A Flax params tree -> {port parameter name: array}."""
    sd = encoder_state_dict_from_jax({"params": tree, "batch_stats": {}}) \
        if "pose_encoder" in tree else \
        generator_state_dict_from_jax({"params": tree, "batch_stats": {}})
    return {k: v.numpy() for k, v in sd.items()}


def compare_grads(port_grads, jax_tree, names):
    ref = torch_named(jax_tree)
    assert names
    worst = 0.0
    for n, g in zip(names, port_grads):
        gj = ref[n]
        scale = np.abs(gj).max()
        diff = np.abs(g.detach().numpy() - gj).max()
        assert diff <= 1e-3 * scale + 1e-7, (n, diff, scale)
        worst = max(worst, diff / (1e-3 * scale + 1e-7))
    return worst


def compare_losses(port_losses, jax_losses, keys):
    for k in keys:
        a, b = float(torch.as_tensor(port_losses[k]).detach()), float(jax_losses[k])
        assert abs(a - b) <= LOSS_RTOL * abs(b) + 1e-12, (k, a, b)


def jax_cycle_grad64(jsys, state, gen_in, feats):
    """The JAX package's generator gradient of the cycle loss with the
    encoder frozen (train-mode generator, eval-mode encoder, shape term
    on), in float64, on the given generator input and targets."""
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)

        stats, enc = f64(state.generator["batch_stats"]), f64(state.encoder)
        target = {k: jnp.asarray(v.numpy(), jnp.float64) for k, v in feats.items()}

        def cycle(params):
            recon, _ = jsys.generator.apply({"params": params, "batch_stats": stats},
                                            jnp.asarray(gen_in, jnp.float64), train=True,
                                            mutable=["batch_stats"])
            out = jsys.encoder.apply(enc, recon, train=False)
            return (landmark_mse(out["expression_params"], target["expression_params"])
                    + 10.0 * landmark_mse(out["jaw_params"], target["jaw_params"])
                    + 10.0 * landmark_mse(out["eyelid_params"], target["eyelid_params"])
                    + landmark_mse(out["shape_params"], target["shape_params"]))

        grads = jax.jit(jax.grad(cycle))(f64(state.generator["params"]))
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)


def path1_draws(jsys, state, batch, rng):
    """_loss1's draws from `rng` in the JAX package's order: the mesh
    points' coords (on JAX's own projected mesh), the hint noise and the
    drop centres."""
    kpts, kmask = jax.random.split(rng)
    enc_out, _ = jsys._apply_encoder(state.encoder, jnp.asarray(batch["img"]), True)
    fl = jsys.flame(enc_out)
    tv = jsys.renderer.project(fl["vertices"], enc_out["cam"])
    _, coords = JM.sample_mesh_points(kpts, tv, jsys.flame.faces, jsys.face_probabilities,
                                      jsys.num_mask_points, S, incidence=jsys.flame_incidence)
    kn, kp = jax.random.split(kmask)
    return {"coords": {k: t(v).long() if v.dtype == jnp.int32 else t(v)
                       for k, v in coords.items()},
            "noise": t(jax.random.normal(kn, (B, S, S, 3))),
            "drop_centers": t(jax.random.bernoulli(kp, 0.01, (B, S, S, 1))).float()}


def augment_draws_from_jax(k_aug, n, D, n_templates):
    ks = jax.random.split(k_aug, 20)
    q = n // 4
    r = n - 3 * q
    u, nrm = jax.random.uniform, jax.random.normal
    d = {
        "perm": jax.random.permutation(ks[0], n),
        "pm": jax.random.bernoulli(ks[1], 0.5, (q, D)).astype(jnp.float32),
        "noise0": nrm(ks[2], (q, D)), "scale0": u(ks[3], (q, 1)),
        "jitter_scale0": u(ks[4], (q, 1)), "jitter0": nrm(ks[5], (q, D)),
        "inner": jax.random.permutation(ks[6], q),
        "scale1": u(ks[7], (q, 1)), "jitter_scale1": u(ks[8], (q, 1)),
        "jitter1": nrm(ks[9], (q, D)),
        "tidx": jax.random.randint(ks[10], (q,), 0, n_templates),
        "scale2": u(ks[11], (q, 1)), "jitter_scale2": u(ks[12], (q, 1)),
        "jitter2": nrm(ks[13], (q, D)),
        "jaw_mask": jax.random.bernoulli(ks[14], 0.5, (n, 1)).astype(jnp.float32),
        "jaw_noise": nrm(ks[15], (n, 3)),
        "eyelid_u": u(ks[16], (n, 2)),
        "jitter_scale3": u(ks[17], (r, 1)), "jitter3": nrm(ks[18], (r, D)),
        "eyelid3": u(ks[19], (r, 2)),
    }
    return {k: t(v) for k, v in d.items()}


def test_loss1_matches_jax(bundle, jax_system):
    """Path 1 in train mode: every sub-loss, the encoder's and the
    generator's gradients, and the updated BN statistics."""
    jsys, state, _ = jax_system
    batch = make_batch(0)
    rng = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), (g_enc, g_gen) = jax.jit(
        jax.value_and_grad(jsys._loss1, argnums=(0, 1), has_aux=True), static_argnums=(6,))(
        state.encoder["params"], state.generator["params"], state.encoder["batch_stats"],
        state.generator["batch_stats"], jb, rng, True)

    psys = port_system(bundle, state)
    draws = path1_draws(jsys, state, batch, rng)
    total, aux = psys._loss1(psys._batch(batch), True, draws=draws)
    compare_losses(aux["losses"], aux_j["losses"], LOSS_KEYS)
    assert abs(float(total.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert float(aux_j["losses"]["reconstruction_loss"]) > 0
    np.testing.assert_allclose(aux["masked_img"].numpy(), np.asarray(aux_j["masked_img"]),
                               rtol=0, atol=1e-6)
    enc_names = [n for n, p in psys.encoder.named_parameters() if p.requires_grad]
    gen_names = [n for n, _ in psys.generator.named_parameters()]
    assert enc_names and all(n.startswith("expression_encoder") for n in enc_names)
    grads = psys._grads(total, psys.enc_params + psys.gen_params)
    n_enc = len(enc_names)
    w_enc = compare_grads(grads[:n_enc], g_enc, enc_names)
    w_gen = compare_grads(grads[n_enc:], g_gen, gen_names)
    for module, stats in ((psys.encoder, aux_j["enc_stats"]), (psys.generator, aux_j["gen_stats"])):
        conv = encoder_state_dict_from_jax if module is psys.encoder else generator_state_dict_from_jax
        want = conv({"params": {}, "batch_stats": stats})
        got = module.state_dict()
        for k, v in want.items():
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    print(f"worst gradient ratio: encoder {w_enc:.3g}, generator {w_gen:.3g}")


@pytest.mark.parametrize("parity", [0, 1])
def test_loss2_matches_jax(bundle, jax_system, parity):
    """The cycle path with Ke=2 (4 augmented rows, one per group): the
    cycle loss and the unfrozen module's gradients (parity 0: generator,
    through the frozen encoder; parity 1: encoder)."""
    jsys, state, _ = jax_system
    batch = make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, aux1 = jax.jit(jsys._loss1, static_argnums=(6,))(
        state.encoder["params"], state.generator["params"], state.encoder["batch_stats"],
        state.generator["batch_stats"], jb, jax.random.PRNGKey(4), True)
    enc_out, tv = aux1["encoder_output"], aux1["transformed_vertices"]
    rng = jax.random.PRNGKey(10 + parity)
    freeze_enc = parity == 0
    (loss_j, aux_j), (g_enc, g_gen) = jax.jit(
        jax.value_and_grad(jsys._loss2, argnums=(0, 1), has_aux=True),
        static_argnums=(8, 9))(
        state.encoder["params"], state.generator["params"], state.encoder["batch_stats"],
        state.generator["batch_stats"], jb, enc_out, tv, rng, freeze_enc, not freeze_enc)

    k_aug, k_p1, k_mask, _ = jax.random.split(rng, 4)
    _, coords = JM.sample_mesh_points(k_p1, tv, jsys.flame.faces, jsys.face_probabilities,
                                      jsys.num_mask_points, S, incidence=jsys.flame_incidence)
    kn, kp = jax.random.split(k_mask)
    n = KE * B
    draws = {
        "augment": augment_draws_from_jax(k_aug, n, ARCH["num_expression"], 1),
        "coords": {k: t(v).long() if v.dtype == jnp.int32 else t(v) for k, v in coords.items()},
        "noise": t(jax.random.normal(kn, (n, S, S, 3))),
        "drop_centers": t(jax.random.bernoulli(kp, 0.005, (n, S, S, 1))).float(),
    }
    psys = port_system(bundle, state)
    enc_t = {k: t(v) for k, v in enc_out.items()}
    total, aux = psys._loss2(psys._batch(batch), enc_t, t(tv), freeze_enc, not freeze_enc,
                             draws=draws)
    compare_losses(aux["losses"], aux_j["losses"], ("cycle_loss", "raster_overflow_2nd"))
    assert abs(float(total.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    np.testing.assert_allclose(aux["viz"]["masked_img_2nd"].numpy(),
                               np.asarray(aux_j["viz"]["masked_img_2nd"]), rtol=0, atol=1e-6)
    if freeze_enc:
        names = [n for n, _ in psys.generator.named_parameters()]
        gen_in = torch.cat([aux["viz"]["rendered_img_2nd"], aux["viz"]["masked_img_2nd"]],
                           dim=-1).numpy()
        feats = psys._augment_feats({k: torch.cat([v] * KE) for k, v in enc_t.items()},
                                    draws=draws["augment"])
        ref64 = jax_cycle_grad64(jsys, state, gen_in, feats)
        worst = compare_grads(psys._grads(total, psys.gen_params), ref64, names)
        r32, r64 = torch_named(g_gen), torch_named(ref64)
        jax_err = max(np.abs(r32[n] - r64[n]).max() / np.abs(r64[n]).max() for n in names)
        print(f"JAX fp32 generator gradient vs its float64: worst {jax_err:.3g} of max")
    else:
        names = [n for n, p in psys.encoder.named_parameters() if p.requires_grad]
        worst = compare_grads(psys._grads(total, psys.enc_params), g_enc, names)
    print(f"parity {parity}: cycle {float(aux['losses']['cycle_loss'].detach()):.6g}, worst "
          f"gradient ratio {worst:.3g}")


def adam_count(opt):
    return int(opt.state[opt.param_groups[0]["params"][0]]["step"])


def test_adam_update_matches_optax():
    """Three Adam steps on the same gradients equal optax's scale_by_adam
    followed by -lr * update, with both the encoder's and the generator's
    betas."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    for b1, b2 in ((0.9, 0.999), (0.5, 0.999)):
        params = [rng.normal(size=s).astype(np.float32) for s in shapes]
        tx = optax.scale_by_adam(b1=b1, b2=b2)
        jp = [jnp.asarray(p) for p in params]
        state = tx.init(jp)
        ours = [t(p) for p in params]
        opt = adam(ours, b1=b1, b2=b2)
        for step, lr in enumerate((1e-3, 5e-4, 2e-4)):
            grads = [rng.normal(size=s).astype(np.float32) * 10.0 ** -step for s in shapes]
            upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
            jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: -jnp.float32(lr) * u, upd))
            adam_step(opt, [t(g) for g in grads], lr)
            for a, b in zip(ours, jp):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        assert adam_count(opt) == 3
    assert adam([]) is None


def test_cosine_schedule_and_clip_rule():
    """The per-iteration cosine schedule restarted every epoch, and the
    generator clip scale min(1, 0.1 / max(||g||, 1e-12)), which is not
    clip_grad_norm_'s 0.1 / (||g|| + 1e-6)."""
    ours = cosine_epoch_restart(2.5e-4, 7)
    ref = _cosine_epoch_restart(2.5e-4, 7)
    for step in range(20):
        assert abs(ours(step) - float(ref(step))) <= 1e-6 * 2.5e-4
    assert ours(7) == ours(0) and ours(3) < ours(0)
    for scale in (1e-3, 1.0, 40.0):
        grads = [torch.full((3,), scale), torch.full((2, 2), -scale)]
        norm = float(np.sqrt(7) * scale)
        clipped = clip_by_global_norm(grads, 0.1)
        want = min(1.0, 0.1 / max(norm, 1e-12))
        for c, g in zip(clipped, grads):
            torch.testing.assert_close(c, g * want, rtol=1e-6, atol=0)
        if norm > 0.1:
            via_torch = [g.clone() for g in grads]
            torch.nn.utils.clip_grad_norm_(via_torch, 0.1)
            assert not torch.equal(via_torch[0], clipped[0]) or norm < 1e-3


def compare_visualizations(jax_system, psys, batch, aux):
    """`make_visualizations` on a train step's aux against the JAX
    package's on the same aux, batch and base-encoder weights: the panels
    the step hands over, and the '2nd_path' stack's layout, exactly; the
    base-encoder, zero-pose and re-encoded renders within 1e-4 on >= 99 %
    of their values (an edge pixel can change faces, as in
    test_torch_infer.py)."""
    jsys, state, _ = jax_system
    psys.base_encoder.load_state_dict(encoder_state_dict_from_jax(state.base_encoder))
    viz = psys.make_visualizations(batch, aux)
    keep = ("encoder_output", "rendered_img", "masked_img", "reconstructed_img",
            "loss_img", "landmarks_fan", "landmarks_mp", "second_path")
    jaux = jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()),
                                  {k: aux.get(k) for k in keep})
    ref = jsys.make_visualizations(state, {"img": jnp.asarray(batch["img"])}, jaux)
    assert set(viz) == set(ref)
    for k in ("rendered_img", "masked_img", "reconstructed_img", "loss_img",
              "landmarks_fan", "landmarks_mp"):
        np.testing.assert_array_equal(viz[k].numpy(), np.asarray(ref[k]), err_msg=k)
    B_, Ke = batch["img"].shape[0], KE
    got, want = viz["2nd_path"].numpy(), np.asarray(ref["2nd_path"])
    assert got.shape == want.shape == (B_ * Ke * 4, S, S, 3)
    passed = np.arange(len(got)) % 4 != 3  # augmented render, masked, reconstruction
    np.testing.assert_array_equal(got[passed], want[passed])
    for k, a, b in (("rendered_img_base", viz["rendered_img_base"].numpy(),
                     ref["rendered_img_base"]),
                    ("rendered_img_zero", viz["rendered_img_zero"].numpy(),
                     ref["rendered_img_zero"]),
                    ("2nd_path re-render", got[~passed], want[~passed])):
        close = np.abs(a - np.asarray(b)) <= 1e-4
        assert np.isfinite(a).all() and close.mean() >= 0.99, (k, close.mean())
    assert float(viz["rendered_img_base"].mean()) > 0  # the renders are not empty


def test_train_step_both_parities(bundle, jax_system):
    """A CPU train_step of each parity moves what the JAX package's
    test_train_step_both_parities expects: the expression encoder and the
    generator move, pose and shape (optimize_* off) do not; the encoder's
    Adam steps once on parity 0 and twice on parity 1, the generator's the
    other way round; the step counter and the batch statistics advance.
    The second step's aux drives `make_visualizations` as the JAX
    package's (`compare_visualizations`)."""
    _, state, _ = jax_system
    psys = port_system(bundle, state)
    batch = make_batch(2, b=4)
    enc0 = {n: p.detach().clone() for n, p in psys.encoder.named_parameters()}
    gen0 = [p.detach().clone() for p in psys.generator.parameters()]
    stats0 = {k: v.clone() for k, v in psys.encoder.state_dict().items() if "running" in k}
    gen = torch.Generator().manual_seed(0)
    m0, aux0 = psys.train_step(batch, 0, gen)
    assert (psys.step, adam_count(psys.enc_opt), adam_count(psys.gen_opt)) == (1, 1, 2)
    m1, aux1 = psys.train_step(batch, 1, gen)
    assert (psys.step, adam_count(psys.enc_opt), adam_count(psys.gen_opt)) == (2, 3, 3)
    for m in (m0, m1):
        for k in ("loss_first_path", "loss_second_path", "cycle_loss",
                  "landmark_loss_mp", "reconstruction_loss"):
            assert np.isfinite(m[k]), k
        assert m["raster_overflow"] == 0 and m["raster_overflow_2nd"] == 0
    assert set(aux1["second_path"]) == {"rendered_img_2nd", "masked_img_2nd",
                                        "reconstructed_img_2nd", "recon_feats"}
    compare_visualizations(jax_system, psys, batch, aux1)

    def moved(prefix):
        return sum(float((p.detach() - enc0[n]).abs().sum())
                   for n, p in psys.encoder.named_parameters() if n.startswith(prefix))

    assert moved("expression_encoder") > 0
    assert moved("pose_encoder") == 0 and moved("shape_encoder") == 0
    assert sum(float((p.detach() - q).abs().sum())
               for p, q in zip(psys.generator.parameters(), gen0)) > 0
    stats = psys.encoder.state_dict()
    for sub in SUB_ENCODERS:  # train-mode BN on all three sub-encoders
        k = f"{sub}.encoder.bn1.running_mean"
        assert not torch.equal(stats[k], stats0[k]), sub
    assert not psys.encoder.training and not psys.generator.training

    before = {k: v.clone() for k, v in psys.encoder.state_dict().items()}
    losses, _ = psys.eval_step(batch, gen)
    assert np.isfinite(losses["landmark_loss_mp"]) and "loss_first_path" not in losses
    for k, v in psys.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert psys.step == 2


def test_base_model_regularization_and_unported_options(bundle, jax_system):
    """use_base_model_for_regularization pulls toward a frozen copy of the
    encoder (taken at construction; here loaded with the same weights, so
    the regularization starts at 0 and grows once the encoder trains); the
    options the port does not carry raise."""
    _, state, _ = jax_system
    psys = port_system(bundle, state, use_base_model_for_regularization=True)
    psys.base_encoder.load_state_dict(psys.encoder.state_dict())
    assert not any(p.requires_grad for p in psys.base_encoder.parameters())
    batch = make_batch(3)
    _, aux = psys._loss1(psys._batch(batch), False)
    assert float(aux["losses"]["expression_regularization"]) == 0.0
    psys.train_step(batch, 1, torch.Generator().manual_seed(0))
    _, aux = psys._loss1(psys._batch(batch), False)
    assert float(aux["losses"]["expression_regularization"]) > 0.0
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH))
    for bad in (dict(arch=dataclasses.replace(cfg.arch, bf16_compute=True)),
                dict(arch=dataclasses.replace(cfg.arch, bf16_cycle_frozen=True)),
                dict(train=dataclasses.replace(cfg.train, remat_cycle=True))):
        with pytest.raises(NotImplementedError):
            SmirkSystem(dataclasses.replace(cfg, **bad), bundle, device="cpu",
                        backbone_stages=STAGES)
    with pytest.raises(NotImplementedError, match="teachers"):
        SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES, vgg_variables={})
