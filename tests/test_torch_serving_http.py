"""The port's serving daemon and reconstruct artifact on the CPU
(smirk_tpu_torch.serving.create_http_server, InferenceServer, the
reconstruct export, cli.serve_client), at S = 64 with tiny backbones and a
generator of 8 features / 1 ResNet block.

Every served output is held bitwise against the port's in-process path on
the same chunk: `SmirkSystem.infer` for the inference artifact, and
`SmirkSystem.reconstruct` with the generator a served chunk draws from
(seeded with seed + chunk index) for the reconstruct artifact; a padded
tail chunk is compared on its real images.

The reconstruct artifact is also held against the JAX package's infer +
reconstruct (`use_pallas=False`, as tests/test_serving.py runs it) on the
same weights, fed the draws of the JAX key (test_torch_reconstruct's
`jax_draws`), at the tolerances of test_torch_reconstruct's comparison on
the same draws: the infer outputs within 1e-4, the masked image within
1e-6, and the reconstruction within 1e-4. A draw whose u lands within
rounding of a cdf boundary may pick the neighbouring face there; at most
two such draws are allowed, so at most 4 masked pixels may differ, and
then the reconstruction's mean |diff| is bounded by 2e-3 instead.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_reconstruct import jax_draws, perturb

from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch import serving
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.cli import serve_client
from smirk_tpu_torch.config import ArchConfig, Config
from smirk_tpu_torch.data import transforms as T
from smirk_tpu_torch.masking import masking as M
from smirk_tpu_torch.train import SmirkSystem
from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
STAGES = {"tf_mobilenetv3_small_minimal_100": TINY_SMALL,
          "tf_mobilenetv3_large_minimal_100": TINY_LARGE}
S, B = 64, 2
ARCH = dict(num_shape=30, num_expression=10)
GEN = dict(generator_features=8, generator_res_blocks=1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny system with the generator, its inference and reconstruct
    artifacts at batch B -> (system, inference path, reconstruct path)."""
    system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)),
                         procedural_bundle(seed=4, full_size=False), device="cpu",
                         backbone_stages=STAGES, training=False, **GEN)
    d = tmp_path_factory.mktemp("srv")
    return (system, serving.export_inference(system, str(d / "inf"), batch_size=B),
            serving.export_reconstruct(system, str(d / "rec"), batch_size=B))


def chunks(a, fill):
    """The server's chunks of `a`: batch B, the tail padded with `fill`."""
    out = []
    for lo in range(0, len(a), B):
        part = a[lo:lo + B]
        pad = B - len(part)
        out.append(np.concatenate([part, np.full((pad,) + part.shape[1:], fill, a.dtype)])
                   if pad else part)
    return out


def direct_reconstruct(system, img, hull, seed):
    """The port's in-process reconstruct of each served chunk, trimmed."""
    res = []
    for ci, (ic, hc) in enumerate(zip(chunks(img, 0.0), chunks(hull, 1.0))):
        out = system.infer(ic)
        gen = torch.Generator().manual_seed((seed + ci) & 0xFFFFFFFFFFFFFFFF)
        masked, recon = system.reconstruct(out, ic, hc, generator=gen)
        res.append({**{k: out[k].numpy() for k in serving.OUTPUT_KEYS},
                    "masked_img": masked.numpy(), "reconstructed_img": recon.numpy()})
    return {k: np.concatenate([r[k] for r in res])[:len(img)] for k in res[0]}


def post(base, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
    return dict(np.load(io.BytesIO(urllib.request.urlopen(req).read())))


def expect_400(base, body: bytes, text: bytes = b""):
    req = urllib.request.Request(base + "/predict", data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400 and text in e.value.read()


def npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def start(path):
    srv = serving.create_http_server(path, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_http_serving_host(served):
    """The daemon: healthz and meta, a ragged /predict (3 images through
    batch 2: chunking, zero tail padding, trimming) bitwise equal to the
    in-process forward on each chunk, an empty batch and a junk body each
    answered 400 with the server still alive."""
    system, path, _ = served
    srv, base = start(path)
    try:
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok"
        meta = json.loads(urllib.request.urlopen(base + "/meta").read())
        assert meta["input"]["shape"] == [B, S, S, 3] and meta["kind"] == "inference"
        img = np.random.default_rng(2).random((3, S, S, 3)).astype(np.float32)
        out = post(base, img=img)
        assert set(out) == set(serving.OUTPUT_KEYS)
        assert all(v.shape[0] == 3 for v in out.values())
        want = [system.infer(c) for c in chunks(img, 0.0)]
        for k in out:
            np.testing.assert_array_equal(
                out[k], torch.cat([w[k] for w in want])[:3].numpy(), err_msg=k)
        expect_400(base, npz(img=np.zeros((0, S, S, 3), np.float32)), b"empty batch")
        expect_400(base, npz(img=np.zeros((1, S + 1, S, 3), np.float32)), b"input shape")
        expect_400(base, b"junk")
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok"
    finally:
        srv.shutdown()


def test_reconstruct_artifact(served):
    """The reconstruct artifact through InferenceServer: its sidecar (kind,
    outputs, the hull and draw inputs, n_upper, image_size); 3 images
    through batch 2, each chunk bitwise equal to SmirkSystem.reconstruct
    with the chunk's generator; deterministic per seed; identical chunks
    draw distinct budgets; negative and 64-bit seeds; the shared draws in
    masked_input's order; the hull's errors."""
    system, _, path = served
    meta = json.load(open(path + ".json"))
    assert meta["kind"] == "reconstruct"
    assert meta["outputs"] == list(serving.RECONSTRUCT_OUTPUTS)
    names = [e["name"] for e in meta["extra_inputs"]]
    assert names == ["hull", "u", "bary", "rsing", "rscale", "noise", "drop_centers"]
    n_upper = system._reconstruct_budget()[0]
    assert (meta["n_upper"], meta["image_size"]) == (n_upper, S)
    assert meta["extra_inputs"][2]["shape"] == [B, n_upper, 3]
    assert meta["extra_inputs"][3]["dtype"] == "int64"

    srv = serving.InferenceServer(path)
    rng = np.random.default_rng(3)
    img = rng.random((3, S, S, 3)).astype(np.float32)
    hull = np.ones((3, S, S, 1), np.float32)
    hull[:, 16:48, 16:48, 0] = 0.0  # the face region (hull: 1 = background)
    out = srv.predict(img, hull, seed=7)
    want = direct_reconstruct(system, img, hull, 7)
    assert set(out) == set(want)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    assert (out["masked_img"] == 0).mean() > 0.05
    assert 0.0 <= out["reconstructed_img"].min() and out["reconstructed_img"].max() <= 1.0
    np.testing.assert_array_equal(srv.predict(img, hull, seed=7)["masked_img"],
                                  out["masked_img"])
    same = np.concatenate([img[:2], img[:2]])
    twin = srv.predict(same, np.concatenate([hull[:2], hull[:2]]), seed=0)["masked_img"]
    assert not np.array_equal(twin[:2], twin[2:])
    for seed in (-1, 2 ** 64 + 5):
        got = srv.predict(img[:1], hull[:1], seed=seed)
        want = direct_reconstruct(system, img[:1], hull[:1], seed)
        np.testing.assert_array_equal(got["masked_img"], want["masked_img"])
    # the shared draws keep the order masked_input has always drawn in
    drawn = system.reconstruct_draws(B, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    u = torch.rand((B, n_upper), generator=g)
    bary = M.random_barycentric((B, n_upper), g)
    rsing = torch.randint(0, 2, (B,), generator=g) * 2 - 1
    rscale = torch.rand((B,), generator=g)
    noise = torch.randn((B, S, S, 3), generator=g)
    drop = torch.bernoulli(torch.full((B, S, S, 1), 0.01), generator=g)
    for k, v in zip(M.RECONSTRUCT_DRAWS, (u, bary, rsing, rscale, noise, drop)):
        assert torch.equal(drawn[k], v), k
    with pytest.raises(ValueError, match="needs `hull`"):
        srv.predict(img)
    with pytest.raises(ValueError, match="hull shape"):
        srv.predict(img, hull[:2])
    with pytest.raises(ValueError, match="empty batch"):
        srv.predict(img[:0], hull[:0])


def test_http_reconstruct_with_client(served, tmp_path, capsys):
    """cli.serve_client.main against the daemon over a reconstruct
    artifact: the landmark crop and hull in the client, hull + seed in the
    request; the reply equals InferenceServer.predict on the same payload;
    a request without a hull is answered 400."""
    system, _, path = served
    srv, base = start(path)
    try:
        H0, W0 = 150, 120
        frame = (np.random.default_rng(5).random((H0, W0, 3)) * 255).astype(np.uint8)
        img_path = str(tmp_path / "face.png")
        Image.fromarray(frame).save(img_path)
        theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
        lmk = np.stack([60 + 30 * np.cos(theta), 75 + 40 * np.sin(theta)], 1)
        lmk_path = str(tmp_path / "lmk.npy")
        np.save(lmk_path, lmk.astype(np.float32))
        out = serve_client.main(["--image", img_path, "--url", base,
                                 "--landmarks", lmk_path, "--seed", "3"])
        assert "reconstructed_img: shape (1, 64, 64, 3)" in capsys.readouterr().out
        kpt = lmk.astype(np.float32)
        tform = T.crop_face_tform(kpt, scale=1.4, image_size=S)
        crop = np.clip(T.warp_affine_np(frame.astype(np.float32), tform, (S, S)), 0, 255) / 255
        hull = T.convex_hull_mask_np(T.transform_points(tform, kpt), (S, S))
        assert 0.1 < hull.mean() < 0.9
        want = srv.inference.predict(crop[None].astype(np.float32),
                                     hull[None, :, :, None], seed=3)
        assert set(out) == set(want)
        for k in out:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
        expect_400(base, npz(img=crop[None].astype(np.float32)), b"hull")
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok"
    finally:
        srv.shutdown()


def seeded_variables(module, shape, seed):
    """Flax variables ({"params", "batch_stats"}) of `module` at input
    `shape`, drawn from a seed without running its init (the shapes come
    from jax.eval_shape): He-normal kernels, BN scales 1 +- 0.1, biases
    and means +- 0.05, variances in [1, 1.3)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        leaf = path[-1].key
        if leaf == "var":
            return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if leaf in ("mean", "bias"):
            return (0.05 * rng.normal(size=x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.normal(size=x.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    v = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    return jax.tree_util.tree_map_with_path(fill, {k: v[k] for k in ("params", "batch_stats")})


def test_reconstruct_artifact_matches_jax(tmp_path):
    """The reconstruct artifact of a system carrying the JAX package's
    encoder weights (perturbed from init, as test_torch_reconstruct's) and
    seeded generator weights, fed the JAX key's draws, against
    JAX infer + reconstruct with that key (tolerances in the module
    doc)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_mnv3.ARCHS, "tf_mobilenetv3_small_minimal_100", (TINY_SMALL, 40))
    mp.setitem(jax_mnv3.ARCHS, "tf_mobilenetv3_large_minimal_100", (TINY_LARGE, 48))
    bundle = procedural_bundle(seed=4, full_size=False)
    try:
        jsys = JaxSmirkSystem(JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH)), bundle,
                              steps_per_epoch=1, use_pallas=False, **GEN)
        ev = jax.jit(jsys.encoder.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
        enc = perturb({k: ev[k] for k in ("params", "batch_stats")}, 7)
        gen = seeded_variables(jsys.generator, (1, S, S, 6), 8)
        img = np.random.default_rng(1).random((B, S, S, 3), np.float32)
        hull = np.ones((B, S, S, 1), np.float32)
        hull[:, 12:56, 14:50, 0] = 0.0  # the face region (hull: 1 = background)
        key = jax.random.PRNGKey(3)
        out_j = jsys.infer(enc, jnp.asarray(img))
        masked_j, recon_j = (np.asarray(a) for a in jax.jit(jsys.reconstruct)(
            gen, out_j, jnp.asarray(img), jnp.asarray(hull), key))
    finally:
        mp.undo()
    system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)), bundle, device="cpu",
                         backbone_stages=STAGES, training=False, **GEN)
    system.encoder.load_state_dict(encoder_state_dict_from_jax(enc))
    system.generator.load_state_dict(generator_state_dict_from_jax(gen))
    call = serving.load_inference(serving.export_reconstruct(system, str(tmp_path / "rec"),
                                                             batch_size=B))
    draws = jax_draws(key, B)
    got = {k: v.numpy() for k, v in call(img, hull, *(draws[k] for k in
                                                     M.RECONSTRUCT_DRAWS)).items()}
    assert np.asarray(out_j["rendered_mask"]).mean() > 0.05
    for k in ("vertices", "landmarks_fan", "landmarks_mp", "cam", "pose_params"):
        np.testing.assert_allclose(got[k], np.asarray(out_j[k]), rtol=0, atol=1e-4, err_msg=k)
    assert 0.05 < (masked_j == 0).mean() < 0.95
    off = (np.abs(got["masked_img"] - masked_j) > 1e-6).any(-1)
    assert off.sum() <= 4, off.sum()
    if not off.any():
        np.testing.assert_allclose(got["reconstructed_img"], recon_j, rtol=0, atol=1e-4)
    else:
        assert np.abs(got["reconstructed_img"] - recon_j).mean() < 2e-3
