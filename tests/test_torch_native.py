"""The port's native host-ops library (smirk_tpu_torch.native, libfastops)
against its numpy oracles and against the JAX package's library.

The port's copy of fastops.cpp is built at first use with g++. It is held
to the port's numpy oracles with tests/test_native_ops.py's cases and
tolerances: the bilinear warp within 1e-5 on [0, 1] images, the nearest
warp, the hull fill and CLAHE on a u8 channel exactly, the whole CLAHE op
within one 8-bit level on < 0.1 % of pixels (a 1-ulp transcendental
difference can flip a level at a tie). The batch entry points equal the
single ones bitwise. The JAX package's fastops.cpp, built from its own
source into a temporary directory with the same flags and loaded through
`smirk_tpu.native` by patching its `_LIB_PATH` / `_lib`, gives bitwise the
port's results, entry point by entry point and through a whole loader
sample (`prepare_sample`) at each seed. A stale library is rebuilt, an up
to date one is not, and a failed build or a missing g++ raises.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

from smirk_tpu import native as JN
from smirk_tpu.data import base as JB
from smirk_tpu_torch import native as PN
from smirk_tpu_torch.data import base as PB
from smirk_tpu_torch.data import transforms as PT
from test_torch_data import BRANCH_SEEDS, raw_face
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

JAX_SOURCE = os.path.join(os.path.dirname(JN.__file__), "fastops.cpp")


def mats(rng, n):
    out = []
    for _ in range(n):
        M = np.eye(3)
        th = rng.uniform(-0.4, 0.4)
        s = rng.uniform(0.7, 1.3)
        M[:2, :2] = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        M[:2, 2] = rng.uniform(-5, 5, 2)
        out.append(M)
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """The JAX package's fastops.cpp built from its source with the port's
    flags into a temporary directory, loaded through `smirk_tpu.native`
    (its `_LIB_PATH` and `_lib` patched; nothing in smirk_tpu/ is written)."""
    lib = str(tmp_path_factory.mktemp("jaxlib") / "libfastops.so")
    subprocess.run(["g++", *PN.CXX_FLAGS, JAX_SOURCE, "-o", lib], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "_LIB_PATH", lib)
    mp.setattr(JN, "_lib", None)
    assert JN.load() is not None
    yield JN
    mp.undo()


def test_entry_points_match_numpy_oracles():
    rng = np.random.default_rng(0)
    img = rng.random((37, 45, 3)).astype(np.float32)
    for M in mats(rng, 4):
        np.testing.assert_allclose(PN.warp_affine(img, M, (32, 32)),
                                   PT.warp_affine_np(img, M, (32, 32)), rtol=0, atol=1e-5)
    img1 = np.random.default_rng(8).random((50, 44, 1)).astype(np.float32)
    for M in mats(rng, 6):
        np.testing.assert_array_equal(PN.warp_affine_nearest(img1, M, (40, 48)),
                                      PT._warp_affine_nearest_np(img1, M, (40, 48)))
    for _ in range(4):
        pts = rng.uniform(3, 28, (25, 2))
        np.testing.assert_array_equal(PN.convex_hull_mask(pts, (32, 32)),
                                      PT.convex_hull_mask_np(pts, (32, 32)))
    # divisible and non-divisible tile grids, images smaller than the grid
    # (reflect-101 pads wider than the image), the augment's clip range
    for shape in [(224, 224), (223, 225), (64, 100), (8, 8), (4, 4), (1, 16), (16, 1),
                  (3, 7), (7, 229)]:
        for clip in [0.7, 1.0, 2.5, 4.0, 40.0]:
            ch = rng.integers(0, 256, shape).astype(np.uint8)
            np.testing.assert_array_equal(PN.clahe_u8(ch, clip), PT._clahe_apply_u8(ch, clip))
    for clip in [1.0, 2.2, 3.9]:
        img = rng.random((96, 80, 3)).astype(np.float32)
        d = np.abs(PN.clahe_rgb(img, clip).astype(np.float64) - PT._clahe_np(img, clip)) * 255
        assert d.max() <= 1.0 + 1e-6 and (d > 0.5).mean() < 1e-3, (clip, d.max())
        np.testing.assert_array_equal(PT._clahe(img, clip), PN.clahe_rgb(img, clip))


def test_batch_entry_points_match_single():
    rng = np.random.default_rng(2)
    imgs = rng.random((6, 40, 48, 3)).astype(np.float32)
    Ms = mats(rng, 6)
    batch = PN.warp_affine_batch(imgs, Ms, (32, 32), n_threads=4)
    for i in range(6):
        np.testing.assert_array_equal(batch[i], PN.warp_affine(imgs[i], Ms[i], (32, 32)))
    pts = rng.uniform(2, 28, (5, 20, 2))
    masks = PN.convex_hull_mask_batch(pts, (32, 32), n_threads=3)
    for i in range(5):
        np.testing.assert_array_equal(masks[i], PN.convex_hull_mask(pts[i], (32, 32)))


def test_library_bitwise_equal_to_jax_library(jax_library):
    rng = np.random.default_rng(3)
    img = rng.random((61, 53, 3)).astype(np.float32) * 255
    for M in mats(rng, 4):
        np.testing.assert_array_equal(PN.warp_affine(img, M, (48, 40)),
                                      jax_library.warp_affine(img, M, (48, 40)))
        np.testing.assert_array_equal(PN.warp_affine_nearest(img[..., :1], M, (48, 40)),
                                      jax_library.warp_affine_nearest(img[..., :1], M, (48, 40)))
    for _ in range(4):
        pts = rng.uniform(-5, 70, (105, 2))
        np.testing.assert_array_equal(PN.convex_hull_mask(pts, (64, 56)),
                                      jax_library.convex_hull_mask(pts, (64, 56)))
    for clip in (1.0, 2.7, 4.0):
        ch = rng.integers(0, 256, (97, 131)).astype(np.uint8)
        np.testing.assert_array_equal(PN.clahe_u8(ch, clip), jax_library.clahe_u8(ch, clip))
        rgb = rng.random((90, 70, 3)).astype(np.float32)
        np.testing.assert_array_equal(PN.clahe_rgb(rgb, clip), jax_library.clahe_rgb(rgb, clip))
    imgs = rng.random((5, 40, 48, 3)).astype(np.float32)
    Ms = mats(rng, 5)
    np.testing.assert_array_equal(PN.warp_affine_batch(imgs, Ms, (32, 32), 3),
                                  jax_library.warp_affine_batch(imgs, Ms, (32, 32), 3))
    pts = rng.uniform(2, 28, (4, 30, 2))
    np.testing.assert_array_equal(PN.convex_hull_mask_batch(pts, (32, 32), 2),
                                  jax_library.convex_hull_mask_batch(pts, (32, 32), 2))


def test_loader_sample_matches_jax_on_that_library(jax_library):
    """prepare_sample at each seed (the CLAHE, blur, hue and warp branches;
    training and test mode, with and without FAN labels): the port's
    sample on its library equals, bitwise, the JAX package's on the JAX
    library built from its source."""
    cases = [(s, False, True) for s in BRANCH_SEEDS] + [(3, False, False), (0, True, True)]
    for seed, test, with_fan in cases:
        img, fan, mp = raw_face(seed)
        fan = fan if with_fan else None
        scale = 1.6 if test else [1.2, 1.8]
        got = PB.prepare_sample(np.random.default_rng(seed), img, fan, mp, 224, scale, test)
        want = JB.prepare_sample(np.random.default_rng(seed), img, fan, mp, 224, scale, test)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, (seed, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"seed {seed} {k}")


def test_stale_rebuild_and_failed_build(tmp_path, monkeypatch):
    src = tmp_path / "fastops.cpp"
    shutil.copyfile(PN.SOURCE, src)
    lib = tmp_path / "build" / "libfastops.so"
    monkeypatch.setattr(PN, "SOURCE", str(src))
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PN, "LIB_PATH", str(lib))
    monkeypatch.setattr(PN, "_lib", None)
    first = PN.build()
    assert first["seconds"] > 0 and lib.is_file()
    assert PN.build() == {}  # up to date: not rebuilt
    t = lib.stat().st_mtime
    os.utime(src, (t + 10, t + 10))  # the source is newer
    assert PN.build()["seconds"] > 0 and lib.stat().st_mtime >= t
    assert PN.load() is not None and PN.convex_hull_mask(
        np.array([[1, 1], [10, 1], [1, 10]]), (12, 12)).min() == 0
    assert os.listdir(tmp_path / "build") == ["libfastops.so"]  # no .tmp left

    src.write_text(src.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected"):
        PN.build()
    assert os.listdir(tmp_path / "build") == ["libfastops.so"]
    monkeypatch.setattr(PN.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        PN.build(force=True)
