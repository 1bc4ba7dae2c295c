"""The port's serving export (smirk_tpu_torch.serving) on the CPU: K1 as a
torch custom op, the inference artifact on both layouts (written with
`torch.export`, loaded and called) against the port's in-process forward
and the JAX package's `serving.make_inference_fn`, an artifact loaded by a
process that imports no model code, the sharded artifact over 8 CPU
replicas, and the export CLI.

Tolerances: the artifact against the port's `SmirkSystem.infer` on the
same images bitwise (the same operations, traced); against the JAX
package those of tests/test_torch_infer.py: parameters and geometry
within 1e-4, pix_to_face agreeing on >= 99.5 % of pixels, the render
within 1e-4 where it agrees, raster_overflow equal. The sharded artifact
bitwise against the in-process forward on each replica's share of the
batch (the per-device program is the plain one at that batch), and within
1e-5 against the whole batch at once (convolutions block by batch).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smirk_tpu import serving as jax_serving
from smirk_tpu.config import ArchConfig as JaxArchConfig
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.train import SmirkSystem as JaxSmirkSystem
from smirk_tpu_torch import assets, serving
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.cli import export_serving as export_cli
from smirk_tpu_torch.cli import serve as serve_cli
from smirk_tpu_torch.config import ArchConfig, Config
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.render import rasterizer as R
from smirk_tpu_torch.render.renderer import Renderer
from smirk_tpu_torch.train import SmirkSystem
from smirk_tpu_torch.utils.weights import encoder_state_dict_from_jax

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
STAGES = {SMALL: TINY_SMALL, LARGE: TINY_LARGE}
S, B = 64, 2
ARCH = dict(num_shape=30, num_expression=10, enable_fuse_generator=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bundle():
    return procedural_bundle(seed=4, full_size=False)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(6).random((B, S, S, 3), np.float32)


@pytest.fixture(scope="module")
def jax_run(bundle, images):
    """The JAX reference, as tests/test_serving.py runs it (use_pallas=False),
    with tiny backbones patched in with a restore and weights perturbed
    from init -> (variables, make_inference_fn's outputs, infer's
    pix_to_face)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    mp.setitem(jax_mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    try:
        system = JaxSmirkSystem(JaxConfig(image_size=S, arch=JaxArchConfig(**ARCH)),
                                bundle, steps_per_epoch=1, use_pallas=False)
        enc = system.init_state(jax.random.PRNGKey(0)).encoder
        rng = np.random.default_rng(7)

        def perturb(path, x):
            x = np.asarray(x, np.float32)
            leaf = path[-1].key
            if leaf == "var":
                return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
            scale = {"mean": 0.1, "bias": 0.05, "scale": 0.1}.get(leaf, 0.02)
            return (x + scale * rng.normal(size=x.shape)).astype(np.float32)

        variables = jax.tree_util.tree_map_with_path(perturb, dict(enc))
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        served = jax.jit(jax_serving.make_inference_fn(system, jvars))(jnp.asarray(images))
        p2f = system.infer(jvars, jnp.asarray(images))["pix_to_face"]
        return (variables, {k: np.asarray(v) for k, v in served.items()},
                np.asarray(p2f))
    finally:
        mp.undo()


def port_system(bundle, variables=None, **kw):
    system = SmirkSystem(Config(image_size=S, arch=ArchConfig(**ARCH)), bundle,
                         device="cpu", backbone_stages=STAGES, training=False, **kw)
    if variables is not None:
        system.encoder.load_state_dict(encoder_state_dict_from_jax(variables))
    return system


@pytest.fixture(scope="module")
def artifact(bundle, jax_run, tmp_path_factory):
    """The compact layout's artifact at batch B -> (system, path)."""
    system = port_system(bundle, jax_run[0])
    path = serving.export_inference(system, str(tmp_path_factory.mktemp("art") / "inf"),
                                    batch_size=B)
    return system, path


def test_k1_op_opcheck_and_plain(bundle):
    """K1's custom op passes torch.library.opcheck (schema, fake tensor,
    autograd registration, aot dispatch) on both layouts' kept counts; on
    the CPU it is the plain version, bitwise; the public wrapper goes
    through it and refuses a device that is neither CPU nor CUDA."""
    r = Renderer(bundle, image_size=S, device="cpu")
    vt = torch.from_numpy(np.array(bundle["v_template"], np.float32))
    v = vt[None].repeat(2, 1, 1)
    cam = torch.tensor([[7.0, 0.0, 0.0], [6.5, 0.05, -0.02]])
    fv, fn = r._face_geometry(v, r.project(v, cam))
    bins, counts = R.bin_faces_flat(fv, S, r.bin_capacity)
    records = R.fused_records(fv, fn)
    fv = fv.contiguous()
    for compact in (r.raster_compact, None):
        kept, _ = R._windows(counts, compact)
        args = (kept, bins, records, fv, S, 1)
        checks = torch.library.opcheck(R._k1_op, args)
        assert set(checks.values()) == {"SUCCESS"}, checks
        got = R.raster_fused_windows(*args)
        want = R.raster_fused_windows_plain(kept, bins, records, S, 1)
        assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, want))
        assert float((got[0] >= 0).float().mean()) > 0.05
    with pytest.raises(ValueError, match="unsupported device"):
        R.raster_fused_windows(*(t.to("meta") for t in args[:4]), S, 1)


@pytest.mark.parametrize("compact", [None, 0])
def test_inference_artifact(bundle, images, jax_run, compact, tmp_path, artifact):
    """The inference artifact of each layout (compact, padded) round-trips
    bitwise against the port's in-process forward, holds one K1 op and no
    plain walk, carries the sidecar's fields, and matches the JAX package's
    make_inference_fn."""
    variables, ref, ref_p2f = jax_run
    if compact is None:
        system, path = artifact
    else:
        system = port_system(bundle, variables, raster_compact=compact)
        path = serving.export_inference(system, str(tmp_path / "inf"), batch_size=B)
    assert path.endswith(".pt2") and os.path.getsize(path) > 1000
    meta = json.load(open(path + ".json"))
    assert meta["input"]["shape"] == [B, S, S, 3]
    assert meta["outputs"] == list(serving.OUTPUT_KEYS)
    assert meta["platforms"] == ["cpu"] and meta["kind"] == "inference"
    assert meta["torch"] == torch.__version__ and meta["bytes"] == os.path.getsize(path)
    call = serving.load_inference(path)
    assert sum(R.K1_OP.replace("::", ".") in str(n.target)
               for n in call.modules[0].graph.nodes) == 1
    out = {k: v.numpy() for k, v in call(images).items()}
    direct = system.infer(torch.from_numpy(images))
    assert list(out) == list(serving.OUTPUT_KEYS)
    for k in out:
        np.testing.assert_array_equal(out[k], direct[k].numpy(), err_msg=k)

    assert set(ref) == set(out)
    for k in ("pose_params", "cam", "shape_params", "expression_params",
              "eyelid_params", "jaw_params", "vertices", "landmarks_fan", "landmarks_mp"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["raster_overflow"], ref["raster_overflow"])
    agree = direct["pix_to_face"].numpy() == ref_p2f
    assert agree.mean() >= 0.995, agree.mean()
    np.testing.assert_array_equal(out["rendered_mask"][agree], ref["rendered_mask"][agree])
    np.testing.assert_allclose(out["rendered_img"][agree], ref["rendered_img"][agree],
                               rtol=0, atol=1e-4)
    assert ref["rendered_mask"].mean() > 0.05
    assert np.abs(ref["expression_params"]).max() > 1e-3


def test_load_imports_no_model_code(artifact, images, tmp_path):
    """A process that imports only smirk_tpu_torch.serving loads and calls
    the artifact; neither the system, the models, FLAME, JAX nor the JAX
    package is imported."""
    system, path = artifact
    np.save(tmp_path / "img.npy", images)
    script = (
        "import sys, numpy as np\n"
        "from smirk_tpu_torch import serving\n"
        f"out = serving.load_inference({path!r})(np.load({str(tmp_path / 'img.npy')!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'smirk_tpu', 'flax')\n"
        "       or m.startswith(('smirk_tpu_torch.train', 'smirk_tpu_torch.models',\n"
        "                        'smirk_tpu_torch.flame'))]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    out = np.load(tmp_path / "out.npz")
    direct = system.infer(torch.from_numpy(images))
    for k in serving.OUTPUT_KEYS:
        np.testing.assert_array_equal(out[k], direct[k].numpy(), err_msg=k)


def test_sharded_over_cpu_replicas(bundle, jax_run, tmp_path):
    """The sharded artifact over devices=["cpu"] * 8: the sidecar's device
    count and mesh, bitwise equal to the in-process forward on each
    replica's image and within 1e-5 of the whole batch; replicas placed on
    devices other than the export's (cpu:1..7) moved there and bitwise
    equal; an uneven batch is refused at export ("divide"), too few
    devices at load."""
    system = port_system(bundle, jax_run[0])
    path = serving.export_inference_sharded(system, str(tmp_path / "art8"), batch_size=8,
                                            n_devices=8)
    meta = json.load(open(path + ".json"))
    assert meta["nr_devices"] == 8 and meta["device_batch"] == 1
    assert meta["mesh"] == {"axes": ["data"], "shape": [8]}
    assert meta["input"]["shape"] == [8, S, S, 3]
    img = np.random.default_rng(1).random((8, S, S, 3)).astype(np.float32)
    out = serving.load_inference(path, devices=["cpu"] * 8)(img)
    whole = system.infer(torch.from_numpy(img))
    each = [system.infer(torch.from_numpy(img[i:i + 1])) for i in range(8)]
    for k in serving.OUTPUT_KEYS:
        assert torch.equal(out[k], torch.cat([e[k] for e in each])), k
        np.testing.assert_allclose(out[k].numpy(), whole[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    # replicas on devices other than the export's go through
    # move_to_device_pass (cpu:1..7 stand for a host's other cards)
    moved = serving.load_inference(path, devices=[f"cpu:{i}" for i in range(8)])
    for i, g in enumerate(m.graph for m in moved.modules):
        targets = {torch.device(n.kwargs["device"]) for n in g.nodes
                   if n.kwargs.get("device") is not None}
        assert targets == {torch.device(f"cpu:{i}") if i else torch.device("cpu")}, targets
    got = moved(img)
    for k in serving.OUTPUT_KEYS:
        assert torch.equal(got[k], out[k]), k
    with pytest.raises(ValueError, match="divide"):
        serving.export_inference_sharded(system, str(tmp_path / "bad"), batch_size=9,
                                         n_devices=8)
    with pytest.raises(ValueError, match="exported for 8 devices; host has 4"):
        serving.load_inference(path, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="exported for 8 devices; host has 1"):
        serving.load_inference(path)


def test_export_cli_and_serve_parser(tmp_path, monkeypatch, capsys):
    """cli.export_serving.main builds the default-config system (the
    procedural head in place of the FLAME assets, tiny backbones under the
    default names) on the CPU and writes a loadable artifact; a checkpoint
    is read through api.load_weights; --reconstruct with --devices > 1 is
    refused; cli.serve's parser reads the artifact, host and port."""
    monkeypatch.setattr(assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(mnv3.ARCHS, SMALL, TINY_SMALL)
    monkeypatch.setitem(mnv3.ARCHS, LARGE, TINY_LARGE)
    from smirk_tpu_torch.cli.demo import build_system

    ref = build_system(None, use_generator=False, device="cpu")
    for p in ref.encoder.parameters():
        p.data.add_(0.01)
    ckpt = tmp_path / "model.pt"
    torch.save({"smirk_encoder." + k: v for k, v in ref.encoder.state_dict().items()}, ckpt)
    out = str(tmp_path / "cli")
    assert export_cli.main(["--out", out, "--batch", "1", "--device", "cpu",
                            "--checkpoint", str(ckpt)]) == 0
    assert "wrote " + out + ".pt2" in capsys.readouterr().out
    meta = json.load(open(out + ".pt2.json"))
    assert meta["input"]["shape"] == [1, 224, 224, 3] and meta["platforms"] == ["cpu"]
    img = np.random.default_rng(3).random((1, 224, 224, 3)).astype(np.float32)
    got = serving.load_inference(out)(img)
    want = ref.infer(torch.from_numpy(img))
    for k in ("expression_params", "vertices", "rendered_img"):
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(SystemExit):
        export_cli.main(["--out", out, "--reconstruct", "--devices", "2", "--device", "cpu"])
    args = serve_cli.build_parser().parse_args([out + ".pt2", "--port", "0",
                                                "--host", "127.0.0.1"])
    assert (args.artifact, args.port, args.host) == (out + ".pt2", 0, "127.0.0.1")
