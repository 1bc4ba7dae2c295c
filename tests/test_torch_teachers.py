"""PyTorch port vs the JAX package: the frozen teachers (VGG16 perceptual
loss, the EMOCA emotion ResNet50, MICA), their loaders, and their losses in
the training step.

Teachers run at reduced depth in both packages (`LAYERS_R50` and
`IRESNET100_LAYERS` patched to one block a stage, `VGG16_BLOCK_CONVS` to
two narrow blocks where a whole step runs), with seeded random weights
carried by `utils.weights` (the JAX package's variables -> the port's state
dicts) or written to files in the reference checkpoints' layouts. MICA
keeps its 112 px input (its fc needs the 7x7 map), VGG resizes to 224 px.
Tolerance: outputs within 1e-4 (relative and absolute), as the JAX
package's own loss-model parity tests hold them.
"""
import collections
import dataclasses

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
from smirk_tpu.models import emoca_resnet as jemo
from smirk_tpu.models import mica as jmica
from smirk_tpu.models import mobilenetv3 as mnv3
from smirk_tpu.models import teachers as jteachers
from smirk_tpu.models import vgg as jvgg
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.cli import train as cli_train
from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
from smirk_tpu_torch.models import emoca_resnet as pemo
from smirk_tpu_torch.models import mica as pmica
from smirk_tpu_torch.models import teachers as pteachers
from smirk_tpu_torch.models import vgg as pvgg
from smirk_tpu_torch.train.trainer import SmirkSystem
from smirk_tpu_torch.utils import weights as W
from test_torch_precision import jax_variables
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B = 64, 2
ONE_BLOCK = [1, 1, 1, 1]
TINY_VGG = [[(0, 8), (2, 8)], [(5, 16)]]
ARCH = dict(num_expression=10, num_shape=30)
TRAIN = dict(batch_size=B, mask_ratio=0.02, mask_dilation_radius=3, Ke=1)
# the recipes' teacher weights (config_train.yaml, config_pretrain.yaml), the
# cycle off: _loss1 is the path the teachers change
WEIGHTS = dict(perceptual_vgg_loss=10.0, emotion_loss=1.0, mica_loss=10.0, cycle_loss=0.0)
GEN = dict(generator_features=8, generator_res_blocks=1)
TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, what):
    """Within TOL, of a reference that is not vanishingly small."""
    want = np.asarray(want, np.float64)
    assert np.abs(want).max() > 1e-2, (what, np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float64), want, err_msg=what, **TOL)


@pytest.fixture
def reduced(monkeypatch):
    """One block a stage in both packages' ResNets."""
    for mod in (jemo, pemo):
        monkeypatch.setattr(mod, "LAYERS_R50", ONE_BLOCK)
    for mod in (jmica, pmica):
        monkeypatch.setattr(mod, "IRESNET100_LAYERS", ONE_BLOCK)


def perturbed(variables, seed):
    """Flax variables with batch norm made nontrivial: running variances in
    [0.8, 1.3], means, scales and biases moved."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.8, 1.3, x.shape).astype(np.float32)
        scale = {"mean": 0.05, "bias": 0.05, "scale": 0.1}.get(leaf)
        return x if scale is None else (x + scale * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def he_init(module):
    """A seeded state dict for `module`: kernels N(0, 2 / fan in), so that
    activations keep their scale through the depth; vectors N(0, 0.05),
    batch norm at identity with running variances in [0.8, 1.3]."""
    out = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            out[k] = v
        elif v.ndim >= 2:
            out[k] = torch.randn(v.shape) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape) * 0.5 + 0.8
        elif k.endswith("weight") and "prelu" not in k:
            out[k] = 1.0 + torch.randn(v.shape) * 0.05
        else:
            out[k] = torch.randn(v.shape) * 0.05
    return out


def teacher_variables(seed=0):
    """{name: (JAX variables, port module)} of the three teachers at the
    patched depths (and VGG16_BLOCK_CONVS as it stands), one seeded weight
    set each carried by `utils.weights`."""
    out = {}
    for name, jmod, pmod, shape, to_port in (
            ("vgg", jvgg.VGG16Features(), pvgg.VGG16Features(), (1, 224, 224, 3),
             W.vgg_state_dict_from_jax),
            ("emotion", jemo.EmocaResNet50(), pemo.EmocaResNet50(), (1, S, S, 3),
             W.emotion_state_dict_from_jax),
            ("mica", jmica.Mica(), pmica.Mica(), (1, 112, 112, 3),
             W.mica_state_dict_from_jax)):
        torch.manual_seed(seed)
        jv = perturbed(jax_variables(jmod, shape, he_init(type(pmod)())), seed)
        pmod.load_state_dict(to_port(jv))
        out[name] = (jv, pmod.eval())
    return out


def test_teachers_match_jax(reduced):
    """VGG16's four block activations and the perceptual loss, the EMOCA
    embedding and its l2 / l1 / cos distances, and MICA's shape parameters
    against the Flax modules on the same seeded inputs; `resize_bilinear`
    against jax.image.resize, shrinking (antialiased) and growing."""
    tv = teacher_variables()
    rng = np.random.default_rng(0)
    x, y = (rng.random((B, S, S, 3), np.float32) for _ in range(2))
    jv, pv = tv["vgg"]
    with torch.no_grad():
        feats = pv(pvgg.preprocess(torch.from_numpy(x)))
        loss = pvgg.perceptual_loss(pv, torch.from_numpy(x), torch.from_numpy(y))
    want = jax.jit(jvgg.VGG16Features().apply)(jv, jvgg.preprocess(jnp.asarray(x)))
    for i, (a, b) in enumerate(zip(feats, want)):
        close(a.permute(0, 2, 3, 1).numpy(), b, f"vgg block {i}")
    close(float(loss), jax.jit(jvgg.perceptual_loss)(jv, jnp.asarray(x), jnp.asarray(y)),
          "perceptual loss")

    jv, pe = tv["emotion"]
    with torch.no_grad():
        close(pe(torch.from_numpy(x)).numpy(),
              jax.jit(jemo.EmocaResNet50().apply)(jv, jnp.asarray(x)), "emotion embedding")
        distance = jax.jit(jemo.emotion_embedding_distance, static_argnames=("metric",))
        for metric in ("l2", "l1", "cos"):
            got = pemo.emotion_embedding_distance(pe, torch.from_numpy(x), torch.from_numpy(y),
                                                  metric)
            close(got.numpy(), distance(jv, jnp.asarray(x), jnp.asarray(y), metric=metric),
                  f"emotion {metric}")
    with pytest.raises(ValueError):
        pemo.emotion_embedding_distance(pe, torch.from_numpy(x), torch.from_numpy(y), "l3")

    jv, pm = tv["mica"]
    xm = rng.random((B, 112, 112, 3), np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(xm))
    close(got.numpy(), jax.jit(jmica.Mica().apply)(jv, jnp.asarray(xm)), "mica")
    assert not pm.arcface.features.weight.requires_grad

    for size_in, size_out in ((112, S), (S, 224)):
        z = rng.random((B, size_in, size_in, 3), np.float32)
        close(pvgg.resize_bilinear(torch.from_numpy(z), size_out).numpy(),
              jax.image.resize(jnp.asarray(z), (B, size_out, size_out, 3), "bilinear"),
              f"resize {size_in} -> {size_out}")


def test_loaders_read_reference_files(reduced, monkeypatch, tmp_path):
    """Seeded state dicts in the reference checkpoints' layouts (a
    torchvision vgg16 state dict with its classifier; EMOCA's
    {'state_dict': {'backbone.*'}} with the classifier's keys; mica.tar's
    {'arcface', 'flameModel': {'regressor.*', other keys}}) are read by
    the JAX package's loaders and the port's alike: the same outputs, the
    port's modules in eval mode and frozen; an absent path gives None; the
    training CLI's `_teachers` loads each only when its weight is above 0
    and reads the SMIRK_* paths."""
    for mod in (jvgg, pvgg):
        monkeypatch.setattr(mod, "VGG16_BLOCK_CONVS", TINY_VGG)
    torch.manual_seed(1)
    rng = np.random.default_rng(1)

    vgg_sd = {**he_init(pvgg.VGG16Features()), "classifier.0.weight": torch.randn(4, 8),
              "classifier.0.bias": torch.randn(4)}
    emo_sd = {"state_dict": {f"backbone.{k}": v for k, v in {
        **he_init(pemo.EmocaResNet50()), "fc.weight": torch.randn(8, 2048)}.items()}}
    mica = he_init(pmica.Mica())
    mica_tar = {"arcface": {k[len("arcface."):]: v for k, v in mica.items()
                            if k.startswith("arcface.")},
                "flameModel": {**{k: v for k, v in mica.items() if k.startswith("regressor.")},
                               "generator.decoder.weight": torch.randn(3)}}
    paths = {}
    for name, obj in (("vgg.pth", vgg_sd), ("emotion.ckpt", emo_sd), ("mica.tar", mica_tar)):
        paths[name] = str(tmp_path / name)
        torch.save(obj, paths[name])

    x = rng.random((B, S, S, 3), np.float32)
    xm = rng.random((B, 112, 112, 3), np.float32)
    pv = pteachers.load_vgg_teacher(paths["vgg.pth"])
    pe = pteachers.load_emotion_teacher(paths["emotion.ckpt"])
    pm = pteachers.load_mica_teacher(paths["mica.tar"])
    for m in (pv, pe, pm):
        assert not m.training and not any(p.requires_grad for p in m.parameters())
    with torch.no_grad():
        close([a.permute(0, 2, 3, 1).numpy() for a in pv(pvgg.preprocess(torch.from_numpy(x)))][-1],
              jvgg.VGG16Features().apply(jteachers.load_vgg_teacher(paths["vgg.pth"]),
                                         jvgg.preprocess(jnp.asarray(x)))[-1], "vgg loader")
        close(pe(torch.from_numpy(x)).numpy(), jemo.EmocaResNet50().apply(
            jteachers.load_emotion_teacher(paths["emotion.ckpt"]), jnp.asarray(x)),
            "emotion loader")
        close(pm(torch.from_numpy(xm)).numpy(), jmica.Mica().apply(
            jteachers.load_mica_teacher(paths["mica.tar"]), jnp.asarray(xm)), "mica loader")
    # a state dict of vgg16's `features` module alone (keys "0.weight", ...)
    bare = str(tmp_path / "features.pth")
    torch.save({k[len("features."):]: v for k, v in vgg_sd.items() if k.startswith("features.")},
               bare)
    for a, b in zip(pteachers.load_vgg_teacher(bare).state_dict().values(),
                    pv.state_dict().values()):
        assert torch.equal(a, b)
    for load in (pteachers.load_vgg_teacher, pteachers.load_emotion_teacher,
                 pteachers.load_mica_teacher):
        assert load(None) is None and load(str(tmp_path / "absent.pth")) is None

    monkeypatch.setenv("SMIRK_VGG16", paths["vgg.pth"])
    monkeypatch.setenv("SMIRK_EMOTION", paths["emotion.ckpt"])
    monkeypatch.setenv("SMIRK_MICA", paths["mica.tar"])
    cfg = Config(train=TrainConfig(loss_weights=LossWeights(
        perceptual_vgg_loss=1.0, emotion_loss=0.0, mica_loss=1.0)))
    got = cli_train._teachers(cfg, "cpu")
    assert isinstance(got["vgg_variables"], pvgg.VGG16Features)
    assert got["emotion_variables"] is None  # weight 0: not loaded
    assert isinstance(got["mica_variables"], pmica.Mica)


@pytest.fixture
def teacher_systems(reduced, monkeypatch):
    """The JAX and the port's systems (tiny backbones, 64 px, b2, the
    recipes' teacher weights, the teachers at reduced depth and VGG's
    blocks narrow) on one set of weights, the generator's running
    statistics moved far from a batch's so that the emotion loss's eval
    re-forward tells the statistics before the step from those after."""
    for mod in (jvgg, pvgg):
        monkeypatch.setattr(mod, "VGG16_BLOCK_CONVS", TINY_VGG)
    monkeypatch.setitem(mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    monkeypatch.setitem(mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    tv = teacher_variables(seed=2)
    bundle = procedural_bundle(seed=5, full_size=False)
    jcfg = JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH),
                     train=JaxTrainConfig(**TRAIN, loss_weights=JaxLossWeights(**WEIGHTS)))
    jsys = JaxSmirkSystem(jcfg, bundle, steps_per_epoch=10, use_pallas=False,
                          vgg_variables=tv["vgg"][0], emotion_variables=tv["emotion"][0],
                          mica_variables=tv["mica"][0], **GEN)
    cfg = Config(image_size=S, arch=ArchConfig(**ARCH),
                 train=TrainConfig(**TRAIN, loss_weights=LossWeights(**WEIGHTS)))
    psys = SmirkSystem(cfg, bundle, device="cpu", backbone_stages=STAGES, steps_per_epoch=10,
                       vgg_variables=tv["vgg"][1], emotion_variables=tv["emotion"][1],
                       mica_variables=tv["mica"][1], **GEN)
    enc = jax_variables(jsys.encoder, (1, S, S, 3), psys.encoder.state_dict())
    gen = perturbed(jax_variables(jsys.generator, (1, S, S, 6), psys.generator.state_dict()), 3)
    rng = np.random.default_rng(7)
    gen["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.5 * rng.normal(size=x.shape) if p[-1].key == "mean"
                      else rng.uniform(0.2, 0.4, x.shape)).astype(np.float32),
        gen["batch_stats"])
    psys.encoder.load_state_dict(W.encoder_state_dict_from_jax(enc))
    psys.generator.load_state_dict(W.generator_state_dict_from_jax(gen))
    return jsys, psys, enc, gen


def loss1_draws(jsys, enc, img, key):
    """`_loss1`'s draws from `key` in the JAX package's order: the mesh
    points' coords on JAX's own projected train-mode mesh, the hint noise
    and the drop centres."""
    kpts, kmask = jax.random.split(key)

    @jax.jit
    def coords(enc, img):
        enc_out, _ = jsys._apply_encoder(enc, img, True)
        tv = jsys.renderer.project(jsys.flame(enc_out)["vertices"], enc_out["cam"])
        return JM.sample_mesh_points(kpts, tv, jsys.flame.faces, jsys.face_probabilities,
                                     jsys.num_mask_points, S, incidence=jsys.flame_incidence)[1]

    kn, kp = jax.random.split(kmask)
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    return {"coords": {k: t(v).long() if v.dtype == jnp.int32 else t(v)
                       for k, v in coords(enc, jnp.asarray(img)).items()},
            "noise": t(jax.random.normal(kn, (B, S, S, 3))),
            "drop_centers": t(jax.random.bernoulli(kp, 0.01, (B, S, S, 1))).float()}


def test_loss1_teacher_losses_match_jax(teacher_systems):
    """`_loss1` in train mode with all three teachers: the perceptual, the
    emotion and the MICA losses, the total and the updated generator
    statistics against the JAX package's on the JAX key's draws. The
    emotion loss's re-forward reads the generator's statistics as they
    stood before the step's train-mode forward: read after it, the loss
    moves well past the tolerance. With only the emotion loss weighted,
    the generator's parameters get no gradient, the encoder's do."""
    jsys, psys, enc, gen = teacher_systems
    rng = np.random.default_rng(4)
    batch = {"img": rng.random((B, S, S, 3), np.float32),
             "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
             "flag_landmarks_fan": np.ones(B, bool),
             "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
             "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
             "img_mica": rng.random((B, 112, 112, 3), np.float32)}
    key = jax.random.PRNGKey(5)
    total_j, aux_j = jax.jit(jsys._loss1, static_argnums=(6,))(
        enc["params"], gen["params"], enc["batch_stats"], gen["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, key, True)
    draws = loss1_draws(jsys, enc, batch["img"], key)
    total, aux = psys._loss1(psys._batch(batch), True, draws=draws)
    for k in ("perceptual_vgg_loss", "emotion_loss", "mica_loss", "reconstruction_loss"):
        got, want = float(aux["losses"][k].detach()), float(aux_j["losses"][k])
        assert want > 0 and abs(got - want) <= 1e-4 * abs(want), (k, got, want)
    assert abs(float(total.detach()) - float(total_j)) <= 1e-4 * abs(float(total_j))
    want = W.generator_state_dict_from_jax({"params": {}, "batch_stats": aux_j["gen_stats"]})
    got = psys.generator.state_dict()
    for k, v in want.items():
        if "running" in k:
            close(got[k].numpy(), v.numpy(), k)

    # the same re-forward on the statistics after the step's forward
    from smirk_tpu.models.emoca_resnet import emotion_embedding_distance
    after = {"params": gen["params"], "batch_stats": aux_j["gen_stats"]}
    masked = jnp.asarray(aux["masked_img"].numpy())
    gen_in = jnp.concatenate([jnp.asarray(aux["rendered_img"].numpy()), masked], -1)
    moved = float(emotion_embedding_distance(
        jsys.emotion_variables, jsys.generator.apply(after, gen_in, train=False),
        jnp.asarray(batch["img"]), metric="l2").mean())
    want = float(aux_j["losses"]["emotion_loss"])
    assert abs(moved - want) > 100 * 1e-4 * want, (moved, want)

    only_emotion = LossWeights(landmark_loss=0.0, reconstruction_loss=0.0,
                               perceptual_vgg_loss=0.0, emotion_loss=1.0, mica_loss=0.0,
                               cycle_loss=0.0, expression_regularization=0.0,
                               jaw_regularization=0.0, shape_regularization=0.0)
    psys.config = dataclasses.replace(psys.config, train=dataclasses.replace(
        psys.config.train, loss_weights=only_emotion))
    total, _ = psys._loss1(psys._batch(batch), True, draws=draws)
    grads = torch.autograd.grad(total, psys.enc_params + psys.gen_params, allow_unused=True)
    n_enc = len(psys.enc_params)
    assert all(g is None or not g.abs().any() for g in grads[n_enc:])
    assert sum(float(g.abs().sum()) for g in grads[:n_enc] if g is not None) > 0


def test_mica_panels(teacher_systems):
    """`make_visualizations` with the MICA teacher and an `img_mica`
    against the JAX package's on the same aux and batch: the zero-pose
    render of MICA's shape (cam [7, 0, 0]) within 1e-4 on >= 99 % of its
    values (an edge pixel can change faces, as in test_torch_train.py) and
    the 112 px crop resized to the model's size within TOL; without
    `img_mica` neither panel."""
    jsys, psys, enc, _ = teacher_systems
    rng = np.random.default_rng(6)
    img = rng.random((B, S, S, 3), np.float32)
    img_mica = rng.random((B, 112, 112, 3), np.float32)
    aux = psys.eval_step({"img": img, "landmarks_fan": np.zeros((B, 68, 2), np.float32),
                          "flag_landmarks_fan": np.ones(B, bool),
                          "landmarks_mp": np.zeros((B, 105, 2), np.float32),
                          "mask": np.ones((B, S, S, 1), np.float32), "img_mica": img_mica},
                         torch.Generator().manual_seed(0))[1]
    viz = psys.make_visualizations({"img": img, "img_mica": img_mica}, aux)
    keep = ("encoder_output", "rendered_img", "masked_img", "reconstructed_img", "loss_img",
            "landmarks_fan", "landmarks_mp", "second_path")
    jaux = jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()),
                                  {k: aux.get(k) for k in keep})
    # the JAX panels read only the state's base encoder
    state = collections.namedtuple("BaseOnly", "base_encoder")(enc)
    ref = jsys.make_visualizations(
        state, {"img": jnp.asarray(img), "img_mica": jnp.asarray(img_mica)}, jaux)
    got, want = viz["rendered_img_mica_zero"].numpy(), np.asarray(ref["rendered_img_mica_zero"])
    assert got.shape == want.shape == (B, S, S, 3)
    near = np.abs(got - want) <= 1e-4
    assert np.isfinite(got).all() and near.mean() >= 0.99, near.mean()
    assert float(want.mean()) > 0
    close(viz["img_mica"].numpy(), ref["img_mica"], "img_mica")
    assert "img_mica" not in psys.make_visualizations({"img": img}, aux)
