"""The port's demo CLIs end to end on the CPU (smirk_tpu_torch.cli.demo,
smirk_tpu_torch.cli.demo_video), with tiny backbones and the procedural
bundle standing in for the FLAME assets, against the JAX CLI's panel; the
MJPEG-AVI copy; the fake-mediapipe route.

Tolerances: the panel's inverse warp against the JAX package's panel on
the same result within 1e-5 (values in [0, 1], float64 blends rounded
once to float32); the resize back to the frame exactly up to the final
/ 255 (1e-6); a chunk's outputs against each frame run alone within 1e-5
(eval-mode batch norm: the batch changes only the convolutions' blocking);
the video demo's batched crop against the JAX video demo's within 1e-3 on
the 0-255 scale (the warp's bound), its generator branch fed the JAX
demo's infer outputs, hulls and draws: the masked input within 1e-6 (the
same float32 operations) and the reconstruction within 1e-4 (the
frameworks sum convolutions in different orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import smirk_tpu.masking as JM
from smirk_tpu import assets as jax_assets
from smirk_tpu.cli import demo as jax_demo
from smirk_tpu.cli import demo_video as jax_demo_video
from smirk_tpu.data import transforms as JT
from smirk_tpu.models import mobilenetv3 as jax_mnv3
from smirk_tpu.utils import viz as jax_viz
from smirk_tpu.utils import videoio as jax_videoio
from smirk_tpu_torch import assets
from smirk_tpu_torch.assets import procedural_bundle
from smirk_tpu_torch.data import transforms as T
from smirk_tpu_torch.masking import masking as M
from smirk_tpu_torch.models import mobilenetv3 as mnv3
from smirk_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax, generator_state_dict_from_jax,
)

TINY_SMALL = [[("ds", 16, 16, 2)], [("ir", 24, 24, 2)], [("cn", 0, 40, 1)]]
TINY_LARGE = [[("ds", 16, 16, 1)], [("ir", 24, 24, 2)], [("cn", 0, 48, 1)]]
SMALL = "tf_mobilenetv3_small_minimal_100"
LARGE = "tf_mobilenetv3_large_minimal_100"
H0, W0 = 400, 360


@pytest.fixture(autouse=True)
def tiny_port(monkeypatch):
    """No asset root here: the port's load_all gives the procedural head;
    tiny backbones under the default config's names."""
    monkeypatch.setattr(assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(mnv3.ARCHS, SMALL, TINY_SMALL)
    monkeypatch.setitem(mnv3.ARCHS, LARGE, TINY_LARGE)


def _ellipse(n=478):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([180 + 80 * np.cos(theta), 200 + 100 * np.sin(theta)], 1).astype(np.float32)


def _fake_face(tmp_path):
    img = (np.random.default_rng(0).random((H0, W0, 3)) * 255).astype(np.uint8)
    img_path = str(tmp_path / "face.png")
    Image.fromarray(img).save(img_path)
    lmk_path = str(tmp_path / "lmk.npy")
    np.save(lmk_path, _ellipse())
    return img_path, lmk_path, img


@pytest.mark.parametrize("flags", [
    ["--crop", "--use_smirk_generator", "--render_orig"],
    ["--crop"],
    ["--use_smirk_generator", "--render_orig"],  # resize in, resize back
])
def test_demo_main_panel(tmp_path, flags):
    """demo.main writes a panel of the JAX CLI's shape for the same flags;
    the panel's mapping back to the frame matches the JAX package's."""
    from smirk_tpu_torch.cli import demo

    img_path, lmk_path, image = _fake_face(tmp_path)
    out_dir = str(tmp_path / "out")
    demo.main(["--input_path", img_path, "--landmarks", lmk_path, "--out_path", out_dir,
               "--device", "cpu", *flags])
    written = np.asarray(Image.open(os.path.join(out_dir, "face.png")))

    system = demo.build_system(None, "--use_smirk_generator" in flags, "cpu")
    result = demo.process_image(system, image, np.load(lmk_path), "--crop" in flags,
                                "--use_smirk_generator" in flags)
    S = system.config.image_size
    assert result["cropped_image"].shape == (S, S, 3)
    assert ("reconstructed_img" in result) == ("--use_smirk_generator" in flags)
    got = demo.panel(image, result, "--render_orig" in flags, "cpu")
    want = jax_demo.panel(image, result, "--render_orig" in flags)
    assert written.shape == got.shape == want.shape
    ncols = 2 + ("--use_smirk_generator" in flags)
    if "--render_orig" in flags:
        assert want.shape == (H0, ncols * W0, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert want.shape == (S, ncols * S, 3)
        np.testing.assert_array_equal(got, want)
    for k in ("masked_img", "reconstructed_img"):
        if k in result:
            assert result[k].shape == (S, S, 3) and np.isfinite(result[k]).all()


def _jax_video_demo(monkeypatch, argv):
    """The JAX video demo's main on the port's procedural head with tiny
    backbones -> its system and state, and per chunk the points it sampled
    and its masked input, and the float panels it saved."""
    monkeypatch.setattr(jax_assets, "load_all",
                        lambda *a, **k: procedural_bundle(seed=0, full_size=False))
    monkeypatch.setitem(jax_mnv3.ARCHS, SMALL, (TINY_SMALL, 40))
    monkeypatch.setitem(jax_mnv3.ARCHS, LARGE, (TINY_LARGE, 48))
    seen = {"coords": [], "masked": [], "panels": []}
    build, sample, compose = jax_demo.build_system, JM.sample_mesh_points, JM.compose_mask

    def build_system(*a, **k):
        seen["system"], seen["state"] = build(*a, **k)
        return seen["system"], seen["state"]

    def sample_mesh_points(*a, **k):
        npts, coords = sample(*a, **k)
        seen["coords"].append({n: np.asarray(v) for n, v in coords.items()})
        return npts, coords

    def compose_mask(*a, **k):
        masked = compose(*a, **k)
        seen["masked"].append(np.asarray(masked))
        return masked

    monkeypatch.setattr(jax_demo, "build_system", build_system)
    monkeypatch.setattr(JM, "sample_mesh_points", sample_mesh_points)
    monkeypatch.setattr(JM, "compose_mask", compose_mask)
    monkeypatch.setattr(jax_viz, "save_image",
                        lambda img, path: seen["panels"].append(np.asarray(img)))
    jax_demo_video.main(argv)
    return seen


def test_demo_video_frame_dir(tmp_path, capsys, monkeypatch):
    """demo_video.main on a directory of frames (crop, generator, chunks of
    2 over 3 frames, the last one short) writes every frame's panel and the
    joined video; a chunk's outputs equal each frame's run alone. Against
    the JAX video demo on the same frames: prepare_chunk's crops and hull
    masks, and generator_fn on its infer outputs, hulls and draws (its
    own budget of GEN_POINTS, no per-image budget, compose_mask's
    defaults)."""
    from smirk_tpu_torch.cli import demo_video
    from smirk_tpu_torch.cli.demo import build_system

    rng = np.random.default_rng(1)
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    frames = [(rng.random((H0, W0, 3)) * 255).astype(np.uint8) for _ in range(3)]
    for i, f in enumerate(frames):
        Image.fromarray(f).save(frame_dir / f"{i:03d}.png")
    tracks = np.stack([_ellipse() + 4.0 * i for i in range(3)])
    lmk_path = str(tmp_path / "tracks.npy")
    np.save(lmk_path, tracks)
    out_dir = tmp_path / "out"
    demo_video.main(["--input_path", str(frame_dir), "--landmarks", lmk_path, "--crop",
                     "--use_smirk_generator", "--batch", "2", "--out_path", str(out_dir),
                     "--device", "cpu"])
    names = sorted(os.listdir(out_dir))
    assert [n for n in names if n.startswith("frame_")] == [
        f"frame_{i:06d}.jpg" for i in range(3)]
    assert "grid.mp4" in names or "grid.avi" in names
    assert np.asarray(Image.open(out_dir / "frame_000002.jpg")).shape == (224, 3 * 224, 3)
    assert "device fps:" in capsys.readouterr().out

    system = build_system(None, False, "cpu")
    imgs, kpts = demo_video.prepare_chunk(frames, list(tracks), True, 224, "cpu")
    chunk = system.infer(imgs)
    for i in range(3):
        one_img, one_k = demo_video.prepare_chunk(frames[i:i + 1], [tracks[i]], True, 224, "cpu")
        np.testing.assert_array_equal(one_img.numpy()[0], imgs.numpy()[i])
        np.testing.assert_array_equal(one_k[0], kpts[i])
        one = system.infer(one_img)
        for k in ("expression_params", "vertices", "rendered_img"):
            np.testing.assert_allclose(one[k].numpy()[0], chunk[k].numpy()[i],
                                       rtol=0, atol=1e-5, err_msg=k)
    # the video demo's own hint budget (not SmirkSystem.reconstruct's)
    assert demo_video.GEN_POINTS == int(0.05 * 224 * 224)

    jax_out = _jax_video_demo(monkeypatch, [
        "--input_path", str(frame_dir), "--landmarks", lmk_path, "--crop",
        "--use_smirk_generator", "--batch", "2", "--out_path", str(tmp_path / "jax_out")])
    jsys, jstate = jax_out["system"], jax_out["state"]
    system = build_system(None, True, "cpu")
    system.encoder.load_state_dict(encoder_state_dict_from_jax(jstate.encoder))
    system.generator.load_state_dict(generator_state_dict_from_jax(
        {"params": jstate.generator["params"], "batch_stats": jstate.generator["batch_stats"]}))
    panels = jax_out["panels"]
    assert len(panels) == 3 and len(jax_out["masked"]) == 2
    calls = {}

    def sample_mesh_points(*a, coords=None, **k):  # the JAX demo's faces and weights
        calls["num_points"], calls["image_size"] = a[3], a[4]
        return sample(*a, coords=jax_coords, **k)

    def transfer_pixels(*a, **k):
        calls["valid_count"] = k.get("valid_count")
        return transfer(*a, **k)

    def compose_mask(*a, **k):
        calls["compose"] = {n: v for n, v in k.items() if n != "generator"}
        calls["masked"] = compose(*a, **dict(k, noise=noise, drop_centers=centers))
        return calls["masked"]

    sample, transfer, compose = M.sample_mesh_points, M.transfer_pixels, M.compose_mask
    monkeypatch.setattr(M, "sample_mesh_points", sample_mesh_points)
    monkeypatch.setattr(M, "transfer_pixels", transfer_pixels)
    monkeypatch.setattr(M, "compose_mask", compose_mask)
    gen_fn = demo_video.generator_fn(system)
    for idx0, n in ((0, 2), (2, 1)):
        crops_j = np.stack([panels[idx0 + i][:, :224] for i in range(n)])
        imgs, kpts = demo_video.prepare_chunk(frames[idx0:idx0 + n],
                                              list(tracks[idx0:idx0 + n]), True, 224, "cpu")
        np.testing.assert_allclose(imgs.numpy(), crops_j, rtol=0, atol=1e-3 / 255)
        hulls_j = np.stack([JT.convex_hull_mask(JT.transform_points(
            JT.crop_face_tform(tracks[i], 1.4, 224), tracks[i]), (224, 224))
            for i in range(idx0, idx0 + n)])
        np.testing.assert_array_equal(
            T.convex_hull_mask(kpts, (224, 224), "cpu").numpy(), hulls_j)
        # the JAX demo's chunk: padded to --batch, as its jit needs
        pad = np.concatenate([crops_j, np.zeros((2 - n, 224, 224, 3), np.float32)])
        out_j = jsys.infer(jstate.encoder, jnp.asarray(pad))
        np.testing.assert_array_equal(np.asarray(out_j["rendered_img"])[:n],
                                      np.stack([panels[idx0 + i][:, 224:448] for i in range(n)]))
        out = {k: torch.from_numpy(np.array(out_j[k][:n])) for k in (
            "transformed_vertices", "rendered_mask", "rendered_img")}
        # the draws of its gen_fn for this chunk: PRNGKey(idx0) split as it splits
        _, k4 = jax.random.split(jax.random.PRNGKey(idx0))
        kn, kp = jax.random.split(k4)
        noise = torch.from_numpy(np.array(jax.random.normal(kn, pad.shape)[:n]))
        centers = torch.from_numpy(np.asarray(
            jax.random.bernoulli(kp, 0.01, (2, 224, 224, 1)), np.float32)[:n])
        jax_coords = {k: torch.from_numpy(np.array(v[:n]))
                      for k, v in jax_out["coords"][idx0 // 2].items()}
        jax_coords["sampled_faces_indices"] = jax_coords["sampled_faces_indices"].long()
        recon = gen_fn(torch.from_numpy(crops_j), out, torch.from_numpy(hulls_j)[..., None], idx0)
        assert (calls["num_points"], calls["image_size"]) == (demo_video.GEN_POINTS, 224)
        assert calls["valid_count"] is None
        assert calls["compose"].keys() == {"dilation_radius", "rendered_mask"}
        assert calls["compose"]["dilation_radius"] == 10
        np.testing.assert_allclose(calls["masked"].numpy(), jax_out["masked"][idx0 // 2][:n],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(recon.numpy(), np.stack(
            [panels[idx0 + i][:, 448:] for i in range(n)]), rtol=0, atol=1e-4)


def test_videoio_roundtrip(tmp_path):
    """The MJPEG-AVI copy round-trips its own files and reads the JAX
    package's, frame for frame."""
    from smirk_tpu_torch.utils import videoio

    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    frames = [np.clip(np.stack([xx / 64 * 255, yy / 48 * 255,
                                np.full((48, 64), 40.0 * i)], -1), 0, 255).astype(np.uint8)
              for i in range(5)]
    path = str(tmp_path / "own.avi")
    videoio.write_mjpeg_avi(path, frames, fps=30.0)
    meta = videoio.read_mjpeg_avi_meta(path)
    assert meta["frames"] == 5 and meta["size"] == (64, 48)
    assert meta["fps"] == pytest.approx(30.0, rel=1e-3)
    got = list(videoio.iter_mjpeg_avi(path))
    assert len(got) == 5
    for a, b in zip(got, frames):
        assert a.shape == b.shape and np.mean(np.abs(a.astype(float) - b)) < 6.0
    jax_path = str(tmp_path / "jax.avi")
    jax_videoio.write_mjpeg_avi(jax_path, frames, fps=30.0)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    for a, b in zip(videoio.iter_mjpeg_avi(jax_path), jax_videoio.iter_mjpeg_avi(path)):
        np.testing.assert_array_equal(a, b)


def test_demo_crop_via_fake_mediapipe(tmp_path, monkeypatch):
    """--crop with no --landmarks: get_landmarks falls through to the
    mediapipe wrapper (a fake package injected), which sees the image."""
    from test_mediapipe_wrapper import _Pt, _install_fake_mediapipe

    from smirk_tpu_torch.cli import demo, mediapipe_utils

    monkeypatch.setattr(mediapipe_utils, "_detector", None)
    pts = [_Pt(x / W0, y / H0, 0.01) for x, y in _ellipse()]
    captured = {}
    _install_fake_mediapipe(monkeypatch, [pts], captured)
    img_path, _, _ = _fake_face(tmp_path)
    out_dir = str(tmp_path / "out_mp")
    demo.main(["--input_path", img_path, "--crop", "--out_path", out_dir,
               "--device", "cpu"])
    assert os.path.exists(os.path.join(out_dir, "face.png"))
    assert captured["data"].shape == (H0, W0, 3)  # the detector saw the image
    lmk = mediapipe_utils.run_mediapipe(np.zeros((H0, W0, 3), np.uint8))
    np.testing.assert_allclose(lmk[:, :2], _ellipse(), rtol=0, atol=1e-3)
