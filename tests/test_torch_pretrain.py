"""PyTorch port vs the JAX package: the pretrain recipe
(configs/config_pretrain.yaml), and the video demo at batch 1.

The recipe trains all three sub-encoders (optimize_pose, optimize_shape and
optimize_expression true) with no generator and no cycle path, at landmark
weight 100, MICA 10 and expression regularization 1e-2. Both packages read
the recipe file, cut to tiny backbones, 32 px, b2, 10 expression and 30
shape components; MICA runs at reduced depth (one block a stage, as in
tests/test_torch_teachers.py) from one seeded weight set. With no
generator, `_loss1` draws nothing, and its render is the inference raster
(the JAX package's in Pallas interpret mode).

Tolerances: every sub-loss and the total within 1e-4 relative; batch
norm's running statistics within 1e-5; one Adam update on the same
gradients within 1e-6 of optax's (the parameters after a whole step are not
compared: an update is about lr * sign(g), and a gradient that is zero up
to rounding can flip it by 2 lr). Each gradient tensor within
1e-3 max |g_ref| + 1e-6 G, where G is the largest |g_ref| of its
sub-encoder. The second term stands where test_torch_train.py's rule has
1e-7: some pose-encoder batch-norm biases (blocks.0.0.bn2.bias,
blocks.1.0.bn3.bias) get gradients that are zero up to rounding, 3e-7 to
8e-7, and the landmark weight of 100 lifts that rounding noise past a
fixed 1e-7 floor, while G is ~300 on the pose encoder; 1e-6 G is a
rounding-level share of the scale the sub-encoder's sums run at.

The video demo: `cli.demo_video.main` with --crop at --batch 1 and at
--batch 4 on the same frames writes every frame, and each frame's
`SmirkSystem.infer` outputs agree: parameters, vertices and landmarks
within 1e-4, pix_to_face on >= 99.5 % of pixels and the render within
1e-4 where it agrees (eval-mode batch norm treats each image on its own;
the batch changes only the convolutions' blocking).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from smirk_tpu.config import load_config as jax_load_config
from smirk_tpu.models import mica as jmica
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch import assets
from smirk_tpu_torch import config as port_config
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.models import mica as pmica
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.train import trainer
from smirk_tpu_torch.train.trainer import SUB_ENCODERS, SmirkSystem, adam, adam_step
from smirk_tpu_torch.utils import weights as W
from test_torch_precision import jax_variables
from test_torch_teachers import he_init, perturbed
from test_torch_train import jax_init_encoder
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
RECIPE = os.path.join(os.path.dirname(__file__), "..", "configs", "config_pretrain.yaml")
S, B = 32, 2
CUT = (f"image_size={S}", f"train.batch_size={B}", "arch.num_expression=10",
       "arch.num_shape=30")
LOSS_KEYS = ("raster_overflow", "landmark_loss_fan", "landmark_loss_mp",
             "expression_regularization", "shape_regularization",
             "jaw_regularization", "reconstruction_loss", "perceptual_vgg_loss",
             "emotion_loss", "mica_loss")
H0, W0 = 400, 360


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.arange(B) % 4 != 1,
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
        "img_mica": rng.random((B, 112, 112, 3)).astype(np.float32),
    }


def _port_names(tree):
    """A Flax encoder params tree -> {port parameter name: array}."""
    return {k: v.numpy() for k, v in
            W.encoder_state_dict_from_jax({"params": tree, "batch_stats": {}}).items()}


@pytest.fixture(scope="module")
def pretrain():
    """The recipe read by both packages, both systems on one set of
    weights (the encoder's perturbed from init so that batch norm and the
    heads are nontrivial), JAX `_loss1` with `value_and_grad` and the
    port's `_loss1` and `_grads` on one batch."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(jax_mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    for mod in (jmica, pmica):
        mp.setattr(mod, "IRESNET100_LAYERS", [1, 1, 1, 1])
    try:
        bundle = procedural_bundle(seed=5, full_size=False)
        jcfg = jax_load_config(RECIPE, CUT)
        pcfg = port_config.load_config(RECIPE, CUT)
        torch.manual_seed(0)
        mica_v = perturbed(jax_variables(jmica.Mica(), (1, 112, 112, 3),
                                         he_init(pmica.Mica())), 0)
        mica = pmica.Mica()
        mica.load_state_dict(W.mica_state_dict_from_jax(mica_v))
        jsys = JaxSmirkSystem(jcfg, bundle, steps_per_epoch=10, use_pallas=True,
                              mica_variables=mica_v)
        enc = jax_init_encoder(jsys, jax.random.PRNGKey(0), S)
        rng = np.random.default_rng(1)
        enc = jax.tree_util.tree_map_with_path(
            lambda p, x: np.asarray(x) + (0.05 if p[-1].key in ("scale", "bias", "mean")
                                          else 0.01) * rng.normal(size=x.shape).astype(
                                              np.float32), enc)
        enc = jax.tree_util.tree_map(jnp.asarray, enc)
        batch = _batch(0)
        (total_j, aux_j), g_enc = jax.jit(
            jax.value_and_grad(jsys._loss1, has_aux=True), static_argnums=(6,))(
            enc["params"], None, enc["batch_stats"], None,
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3), True)

        psys = SmirkSystem(pcfg, bundle, device="cpu", backbone_stages=STAGES,
                           steps_per_epoch=10, mica_variables=mica)
        psys.encoder.load_state_dict(W.encoder_state_dict_from_jax(enc))
        total, aux = psys._loss1(psys._batch(batch), True)
        grads = psys._grads(total, psys.enc_params)
        yield {"jsys": jsys, "enc": enc, "total_j": total_j, "aux_j": aux_j,
               "g_enc": g_enc, "psys": psys, "total": total, "aux": aux, "grads": grads,
               "stats": {k: v.clone() for k, v in psys.encoder.state_dict().items()},
               "jcfg": jcfg, "pcfg": pcfg}
    finally:
        mp.undo()


def _enc_names(psys):
    """The port's names of `enc_params`, in its order."""
    return [f"{sub}.{n}" for sub in SUB_ENCODERS
            for n, p in getattr(psys.encoder, sub).named_parameters() if p.requires_grad]


def test_pretrain_losses_match_jax(pretrain):
    """Every sub-loss and the total of `_loss1` in train mode: the landmark
    and MICA losses nonzero, no generator term, no raster overflow."""
    aux, aux_j = pretrain["aux"], pretrain["aux_j"]
    for k in LOSS_KEYS:
        a, b = float(torch.as_tensor(aux["losses"][k]).detach()), float(aux_j["losses"][k])
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-12, (k, a, b)
    a, b = float(pretrain["total"].detach()), float(pretrain["total_j"])
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for k in ("landmark_loss_fan", "landmark_loss_mp", "mica_loss",
              "expression_regularization"):
        assert float(aux_j["losses"][k]) > 0, k
    for k in ("raster_overflow", "reconstruction_loss", "perceptual_vgg_loss",
              "emotion_loss"):
        assert float(aux_j["losses"][k]) == 0, k
    assert aux["reconstructed_img"] is None and aux["masked_img"] is None
    print(f"pretrain total: port {a:.8g}, JAX {b:.8g}")


def test_pretrain_trains_all_three_sub_encoders(pretrain):
    """Both packages read the recipe's flags; both train the pose, shape
    and expression encoders, and the system has no generator and no cycle
    path."""
    jcfg, pcfg, psys, jsys = (pretrain[k] for k in ("jcfg", "pcfg", "psys", "jsys"))
    for cfg in (jcfg, pcfg):
        t = cfg.train
        assert (t.optimize_pose, t.optimize_shape, t.optimize_expression) == (True,) * 3
        assert not cfg.arch.enable_fuse_generator and t.loss_weights.cycle_loss == 0
        w = t.loss_weights
        assert (w.landmark_loss, w.mica_loss, w.expression_regularization) == (100.0, 10.0, 1e-2)
    labels = jsys._encoder_labels(pretrain["enc"]["params"])
    jax_trained = {sub for sub, tree in labels.items()
                   if set(jax.tree_util.tree_leaves(tree)) == {"train"}}
    port_trained = {sub for sub in SUB_ENCODERS
                    if all(p.requires_grad for p in getattr(psys.encoder, sub).parameters())}
    assert jax_trained == port_trained == set(SUB_ENCODERS)
    assert len(psys.enc_params) == sum(1 for _ in psys.encoder.parameters())
    assert psys.generator is None and jsys.generator is None
    assert not psys._cycle_enabled() and not jsys._cycle_enabled()
    assert psys.gen_opt is None


def test_pretrain_gradients_match_jax(pretrain):
    """Every gradient tensor of the three sub-encoders within 1e-3 max
    |g_ref| + 1e-6 of the sub-encoder's largest |g_ref| (see the module
    docstring); each sub-encoder gets a nonzero gradient."""
    psys, grads = pretrain["psys"], pretrain["grads"]
    ref = _port_names(pretrain["g_enc"])
    names = _enc_names(psys)
    assert len(names) == len(grads) and set(names) <= set(ref)
    top = {sub: max(np.abs(v).max() for k, v in ref.items() if k.startswith(sub))
           for sub in SUB_ENCODERS}
    assert all(v > 0 for v in top.values()), top
    worst = 0.0
    for n, g in zip(names, grads):
        gj = ref[n]
        bound = 1e-3 * np.abs(gj).max() + 1e-6 * top[n.split(".")[0]]
        diff = np.abs(g.numpy() - gj).max()
        assert diff <= bound, (n, diff, bound)
        worst = max(worst, diff / bound)
    print(f"largest |g| per sub-encoder {top}; worst gradient ratio {worst:.3g}")


def test_pretrain_batch_norm_statistics_match_jax(pretrain):
    """The running statistics the train-mode forward leaves, on all three
    sub-encoders, within 1e-5."""
    want = W.encoder_state_dict_from_jax({"params": {},
                                          "batch_stats": pretrain["aux_j"]["enc_stats"]})
    got = pretrain["stats"]
    running = [k for k in want if "running" in k]
    assert {k.split(".")[0] for k in running} == set(SUB_ENCODERS)
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_pretrain_adam_update_matches_optax(pretrain):
    """One encoder Adam update on the JAX gradients: the port's `adam_step`
    on `enc_params` at `enc_lr(0)` against the JAX system's multi-transform
    (every label "train") and its learning rate, within 1e-6; every
    sub-encoder moves."""
    jsys, enc = pretrain["jsys"], pretrain["enc"]
    g = pretrain["g_enc"]
    upd, _ = jsys.enc_tx.update(g, jsys.enc_tx.init(enc["params"]), enc["params"])
    new = jsys._apply_lr(upd, jsys.enc_lr(0))
    new = _port_names(jax.tree_util.tree_map(lambda p, u: p + u, enc["params"], new))
    before = _port_names(enc["params"])
    psys = pretrain["psys"]
    names = _enc_names(psys)
    params = [p.detach().clone() for p in psys.enc_params]
    ref = _port_names(g)
    adam_step(adam(params), [torch.from_numpy(np.array(ref[n])) for n in names],
              psys.enc_lr(0))
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.numpy(), new[n], rtol=0, atol=1e-6, err_msg=n)
    for sub in SUB_ENCODERS:
        assert any(np.abs(new[n] - before[n]).max() > 0 for n in names if n.startswith(sub)), sub


def test_demo_video_batch1_matches_batch4(tmp_path, monkeypatch):
    """`cli.demo_video.main` with --crop on 4 seeded frames at --batch 1 and
    at --batch 4: 4 panels written each time, and each frame's infer
    outputs agree under the batch-1 rule (module docstring)."""
    from smirk_tpu_torch.cli import demo_video

    monkeypatch.setattr(assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(mnv3.ARCHS, SMALL, TINY_SMALL)
    monkeypatch.setitem(mnv3.ARCHS, LARGE, TINY_LARGE)
    rng = np.random.default_rng(2)
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    for i in range(4):
        Image.fromarray((rng.random((H0, W0, 3)) * 255).astype(np.uint8)).save(
            frame_dir / f"{i:03d}.png")
    theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
    ellipse = np.stack([180 + 80 * np.cos(theta), 200 + 100 * np.sin(theta)], 1)
    np.save(tmp_path / "tracks.npy", np.stack([ellipse + 3.0 * i for i in range(4)])
            .astype(np.float32))
    infer, seen = trainer.SmirkSystem.infer, {}

    def recorded(self, img):
        out = infer(self, img)
        seen.setdefault(run, []).append({k: v.numpy() for k, v in out.items()})
        return out

    monkeypatch.setattr(trainer.SmirkSystem, "infer", recorded)
    for run in (1, 4):
        out_dir = tmp_path / f"out_b{run}"
        demo_video.main(["--input_path", str(frame_dir), "--landmarks",
                         str(tmp_path / "tracks.npy"), "--crop", "--batch", str(run),
                         "--out_path", str(out_dir), "--device", "cpu"])
        assert sorted(n for n in os.listdir(out_dir) if n.startswith("frame_")) == [
            f"frame_{i:06d}.jpg" for i in range(4)]
    assert [len(seen[1]), len(seen[4])] == [4, 1]
    one = {k: np.concatenate([o[k] for o in seen[1]]) for k in seen[1][0]}
    four = seen[4][0]
    for k in ("pose_params", "cam", "shape_params", "expression_params", "eyelid_params",
              "jaw_params", "vertices", "landmarks_fan", "landmarks_mp"):
        np.testing.assert_allclose(one[k], four[k], rtol=0, atol=1e-4, err_msg=k)
    agree = one["pix_to_face"] == four["pix_to_face"]
    assert agree.mean() >= 0.995 and four["rendered_mask"].mean() > 0.01, agree.mean()
    np.testing.assert_allclose(one["rendered_img"][agree], four["rendered_img"][agree],
                               rtol=0, atol=1e-4)
