"""PyTorch port vs the JAX package: the crop and hull-mask transforms
(smirk_tpu_torch.data.transforms).

The JAX package's `warp_affine` and `convex_hull_mask` take the native
library (libfastops) when it is built and scipy / numpy otherwise; the
port is held to both: to the native path as it stands, and to the scipy /
numpy path with `smirk_tpu.native`'s entry points patched to return None.

Tolerances: the similarity estimates and point maps within 1e-9 (float64,
the same operations); the warp within 1e-3 on the 0-255 scale (float64
coordinates and blend, rounded once to float32; the paths sum the four
taps in different orders); the hull masks exactly (integer half-plane
tests on int32-truncated points).
"""
import numpy as np
import pytest
import torch

from smirk_tpu import native
from smirk_tpu.data import transforms as JT
from smirk_tpu_torch.data import transforms as T
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)


def _similarity(angle, scale, tx, ty):
    c, s = np.cos(angle) * scale, np.sin(angle) * scale
    return np.array([[c, -s, tx], [s, c, ty], [0.0, 0.0, 1.0]])


def _numpy_path(monkeypatch):
    """Send the JAX package's transforms down their scipy / numpy path."""
    for name in ("warp_affine", "warp_affine_nearest", "convex_hull_mask"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)


@pytest.fixture(params=["native", "numpy"])
def jax_path(request, monkeypatch):
    """The JAX package's transforms on its native path (when built) or on
    its scipy / numpy path."""
    if request.param == "numpy":
        _numpy_path(monkeypatch)
    return request.param


def test_similarity_crop_points_arcface():
    rng = np.random.default_rng(0)
    for i in range(5):
        src = rng.uniform(-50, 400, (68, 2))
        dst = src @ _similarity(0.3 * i, 0.5 + i, 10, -20)[:2, :2].T + rng.normal(0, 2, (68, 2))
        np.testing.assert_allclose(T.estimate_similarity(src, dst),
                                   JT.estimate_similarity(src, dst), rtol=0, atol=1e-9)
        lmk = rng.uniform(50, 350, (478, 2)).astype(np.float32)
        for scale, size in ((1.4, 224), (1.0, 64)):
            m = T.crop_face_tform(lmk, scale=scale, image_size=size)
            mj = JT.crop_face_tform(lmk, scale=scale, image_size=size)
            np.testing.assert_allclose(m, mj, rtol=0, atol=1e-9)
            np.testing.assert_allclose(T.transform_points(m, lmk),
                                       JT.transform_points(mj, lmk), rtol=0, atol=1e-9)
        np.testing.assert_allclose(T.arcface_tform(src), JT.arcface_tform(src),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(T.arcface_tform(src, 224), JT.arcface_tform(src, 224),
                                   rtol=0, atol=1e-9)
    assert T.MEDIAPIPE_INDICES == JT.MEDIAPIPE_INDICES
    # crop_tforms: the per-image crop and its landmarks, as float32
    lmks = rng.uniform(50, 350, (3, 105, 3))
    tf, kp = T.crop_tforms(lmks, 224)
    assert kp.dtype == np.float32 and kp.shape == (3, 105, 2)
    for b in range(3):
        mj = JT.crop_face_tform(lmks[b, :, :2], scale=1.4, image_size=224)
        np.testing.assert_array_equal(tf[b], mj)
        np.testing.assert_array_equal(kp[b], JT.transform_points(mj, lmks[b, :, :2])
                                      .astype(np.float32))


@pytest.mark.parametrize("order", [1, 0])
def test_warp_matches_jax(jax_path, order):
    """Batched warps over seeded matrices (rotations, up- and downscales,
    partly and wholly out of frame) against the JAX package's per-image
    warp, from a 0-255 image with 3 channels and a mask with 1."""
    rng = np.random.default_rng(order)
    H, W, OH, OW = 97, 83, 64, 72
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    Ms = [_similarity(rng.uniform(-np.pi, np.pi), s, rng.uniform(-60, 60),
                      rng.uniform(-60, 60)) for s in (0.3, 0.8, 1.0, 1.7, 3.5)]
    Ms += [_similarity(0.0, 1.0, 0.5, -0.25), _similarity(0.2, 1.0, 400.0, 0.0),
           T.crop_face_tform(rng.uniform(0, 90, (105, 2)), 1.4, OH)]
    Ms = np.stack(Ms)
    for chans in (img, img[..., :1]):
        got = T.warp_affine(torch.from_numpy(np.stack([chans] * len(Ms))), Ms,
                            (OH, OW), order).numpy()
        assert got.shape == (len(Ms), OH, OW, chans.shape[-1]) and got.dtype == np.float32
        for b, M in enumerate(Ms):
            want = JT.warp_affine(chans, M, (OH, OW), order=order)
            np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-3, err_msg=str(b))
            np.testing.assert_allclose(T.warp_affine_np(chans, M, (OH, OW), order),
                                       want, rtol=0, atol=1e-3)
    assert (got[-2] == 0).all()  # wholly out of frame
    assert (got[:-2] != 0).mean() > 0.3
    with pytest.raises(ValueError, match="order"):
        T.warp_affine(torch.zeros((1, 4, 4, 1)), Ms[:1], (4, 4), order=3)


def test_hull_mask_matches_jax(monkeypatch):
    """Batched hull masks equal the JAX package's exactly, on its native
    path and on its numpy path: landmark-like point sets (partly outside
    the frame, with duplicates after the int truncation), a triangle, and
    fewer than 3 unique points (all ones)."""
    rng = np.random.default_rng(2)
    S = 64
    theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
    sets = [np.stack([32 + 20 * np.cos(theta), 30 + 26 * np.sin(theta)], 1),
            rng.uniform(-10, 80, (105, 2)),
            rng.uniform(10, 50, (105, 2)) + rng.uniform(0, 0.9, (105, 2)),
            np.array([[5.7, 3.2], [60.1, 10.9], [20.5, 55.5]]),
            np.array([[3.2, 3.9], [3.7, 3.1], [9.0, 9.0], [9.9, 9.5]]),  # 2 unique
            np.array([[7.0, 7.0]] * 5)]
    sets = [s.astype(np.float32) for s in sets]
    got = T.convex_hull_mask(sets, (S, S + 8), "cpu").numpy()
    assert got.shape == (len(sets), S, S + 8) and got.dtype == np.float32
    for path in ("native", "numpy"):
        if path == "numpy":
            _numpy_path(monkeypatch)
        for b, pts in enumerate(sets):
            want = JT.convex_hull_mask(pts, (S, S + 8))
            np.testing.assert_array_equal(got[b], want, err_msg=f"{path} {b}")
            np.testing.assert_array_equal(T.convex_hull_mask_np(pts, (S, S + 8)), want)
    assert (got[-2:] == 1).all()
    assert 0.05 < (got[:4] == 0).mean() < 0.95
    # one fill block per edge: the blocked loop gives the same masks
    monkeypatch.setattr(T, "_FILL_BLOCK_ELEMS", 1)
    np.testing.assert_array_equal(T.convex_hull_mask(sets, (S, S + 8), "cpu").numpy(), got)
    if not torch.cuda.is_available():  # no device named: the card, or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.convex_hull_mask(sets, (S, S + 8))
