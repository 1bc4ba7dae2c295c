"""PyTorch port vs the JAX package: the training data pipeline
(smirk_tpu_torch.data: transforms' augmentation, base, tracks, datasets,
pipeline).

The data stream draws from unseeded generators in both packages, so parity
is held per sample with one injected seeded numpy Generator. The seeds of
`BRANCH_SEEDS` take, between them, every augmentation branch whose code
differs most (CLAHE, Blur, ColorJitter, shift-scale-rotate, none), each
checked by counting the port's calls.

Tolerances: against the JAX package's numpy / scipy oracles (its native
library patched away) every array within 1e-5 on [0, 1] images (it
matches bitwise here), the hull mask exactly; against its native library
(when built) within one 8-bit level (1/255) on <= 0.1 % of pixels, since a
1-ulp warp difference can flip CLAHE's u8 rounding; CLAHE and the box
filter bitwise; the samplers' index streams and `collate` exactly.
"""
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from smirk_tpu import native
from smirk_tpu.config import Config as JaxConfig
from smirk_tpu.config import load_config as jax_load_config
from smirk_tpu.data import base as JB
from smirk_tpu.data import datasets as JD
from smirk_tpu.data import pipeline as JP
from smirk_tpu.data import tracks as JTR
from smirk_tpu.data import transforms as JT
from smirk_tpu_torch.config import Config
from smirk_tpu_torch.config import load_config
from smirk_tpu_torch.data import base as PB
from smirk_tpu_torch.data import datasets as PD
from smirk_tpu_torch.data import pipeline as PP
from smirk_tpu_torch.data import tracks as PTR
from smirk_tpu_torch.data import transforms as PT
from torch_cpu_share import cpu_share  # noqa: F401 (autouse: the worker's cores)

# seed -> the branches its draws take (besides the crop's scale)
BRANCH_SEEDS = {5: {"_clahe", "uniform_filter", "_warp_affine_nearest_np"},
                16: {"_clahe", "_rotate_hue", "_warp_affine_nearest_np"},
                4: {"_rotate_hue"}, 23: set()}
NATIVE = ("warp_affine", "warp_affine_nearest", "convex_hull_mask", "clahe_rgb")


def raw_face(seed, H=320, W=320):
    """A synthetic frame (an ellipse face on noise) with 68 FAN and 478
    mediapipe landmarks, as the synthetic dataset draws them."""
    r = np.random.default_rng(1000 + seed)
    cx, cy = r.uniform(120, 200, 2)
    ax, ay = r.uniform(50, 80), r.uniform(65, 95)
    yy, xx = np.mgrid[0:H, 0:W]
    face = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
    img = (r.uniform(0, 60, (H, W, 3)) + face[..., None] * r.uniform(100, 180)
           ).clip(0, 255).astype(np.uint8)
    th = np.linspace(0, 2 * np.pi, 478, endpoint=False)
    mp = np.stack([cx + 0.9 * ax * np.cos(th), cy + 0.9 * ay * np.sin(th)], 1) \
        + r.normal(0, 1, (478, 2))
    th2 = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    fan = np.stack([cx + 0.8 * ax * np.cos(th2), cy + 0.8 * ay * np.sin(th2)], 1)
    return img, fan, mp


def numpy_path(monkeypatch):
    for name in NATIVE:
        monkeypatch.setattr(native, name, lambda *a, **k: None)


def test_prepare_sample_and_augment_match_jax(monkeypatch):
    """prepare_sample (crop, hull, augment, normalization, MICA crop) per
    sample under one seeded Generator, in training and test mode, with and
    without FAN landmarks; against the numpy oracles, then native."""
    calls = []
    for name in ("_clahe", "uniform_filter", "_rotate_hue", "_warp_affine_nearest_np"):
        fn = getattr(PT, name)
        monkeypatch.setattr(PT, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n),
                                                                       _f(*a, **k))[1])
    cases = [(s, False, True) for s in BRANCH_SEEDS] + [(3, False, False), (0, True, True)]

    def run(tol):
        worst = {}
        for seed, test, with_fan in cases:
            img, fan, mp = raw_face(seed)
            fan = fan if with_fan else None
            calls.clear()
            got = PB.prepare_sample(np.random.default_rng(seed), img, fan, mp, 224,
                                    1.6 if test else [1.2, 1.8], test=test)
            if seed in BRANCH_SEEDS and not test:
                assert set(calls) == BRANCH_SEEDS[seed], (seed, calls)
            want = JB.prepare_sample(np.random.default_rng(seed), img, fan, mp, 224,
                                     1.6 if test else [1.2, 1.8], test=test)
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                if k == "mask":
                    np.testing.assert_array_equal(got[k], v)
                else:
                    diff = np.abs(got[k].astype(np.float64) - v)
                    assert diff.max() <= tol(k), (seed, k, diff.max())
                    if k == "img":
                        worst[seed] = (diff.max(), (diff > 1e-5).mean())
        return worst

    with monkeypatch.context() as m:
        numpy_path(m)
        run(lambda k: 1e-5)
    if native.available():
        worst = run(lambda k: 1 / 255 + 1e-6 if k == "img" else 1e-5)
        assert all(share <= 1e-3 for _, share in worst.values()), worst


def test_clahe_and_box_filter_at_edges(monkeypatch):
    """CLAHE (padded, non-tile-divisible sizes) and the box filter's reflect
    boundary, bitwise against the JAX package's numpy CLAHE and scipy's
    uniform_filter; native CLAHE (when built) too."""
    rng = np.random.default_rng(0)
    for H, W in ((37, 45), (64, 64), (9, 7)):
        img = rng.random((H, W, 3)).astype(np.float32)
        img[0, :, :] = 1.0  # a bright edge row, where the reflection shows
        for k in (3, 5, 7):
            np.testing.assert_array_equal(PT.uniform_filter(img, k),
                                          ndimage.uniform_filter(img, size=(k, k, 1)))
        ch = (img[..., 0] * 255).astype(np.uint8)
        for clip in (1.0, 2.5, 4.0):
            np.testing.assert_array_equal(PT._clahe_apply_u8(ch, clip),
                                          JT._clahe_apply_u8(ch, clip))
            if native.available():
                np.testing.assert_array_equal(PT._clahe(img, clip), JT._clahe(img, clip))
            with monkeypatch.context() as m:
                numpy_path(m)
                np.testing.assert_array_equal(PT._clahe(img, clip), JT._clahe(img, clip))
    np.testing.assert_allclose(PT._rotate_hue(img, 0.03), JT._rotate_hue(img, 0.03),
                               rtol=0, atol=0)


def test_samplers_and_collate_match_jax():
    """MixedDatasetSampler's quotas and index stream (per process),
    SimpleBatchSampler's per-epoch shuffles, ConcatDataset's indexing and
    collate (frames, temporal windows, mixed, all None) equal the JAX
    package's."""
    for sizes, ratios, bs, n, pidx, pcount in (([10, 5, 7], [0.2, 0.5, 0.3], 8, 64, 0, 1),
                                               ([100, 3], [0.9, 0.1], 6, 60, 1, 2)):
        a = PP.MixedDatasetSampler(sizes, ratios, bs, n, seed=3, process_index=pidx,
                                   process_count=pcount)
        b = JP.MixedDatasetSampler(sizes, ratios, bs, n, seed=3, process_index=pidx,
                                   process_count=pcount)
        assert len(a) == len(b) and list(a.per_batch) == list(b.per_batch)
        assert list(a) == list(b) and list(a) == list(b)
    with pytest.raises(ValueError, match="empty"):
        list(PP.MixedDatasetSampler([4, 0], [0.5, 0.5], 4, 8))
    a, b = PP.SimpleBatchSampler(10, 3, shuffle=True, seed=2), JP.SimpleBatchSampler(
        10, 3, shuffle=True, seed=2)
    first = list(a)
    assert first == list(b) and list(a) == list(b) != first and len(a) == 3

    ca = PP.ConcatDataset([list(range(3)), list(range(10, 15))])
    cb = JP.ConcatDataset([list(range(3)), list(range(10, 15))])
    assert len(ca) == len(cb) == 8 and [ca[i] for i in range(8)] == [cb[i] for i in range(8)]

    rng = np.random.default_rng(1)

    def sample(K=None):
        lead = () if K is None else (K,)
        return {"img": rng.random(lead + (4, 4, 3)).astype(np.float32),
                "landmarks_mp": rng.random(lead + (105, 2)).astype(np.float32),
                "flag_landmarks_fan": np.ones(lead, bool) if K else np.asarray(True)}

    for samples in ([sample(), None, sample()], [sample(3), sample(2)],
                    [sample(), sample(3), None, sample()]):
        got, want = PP.collate(samples), JP.collate(samples)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert PP.collate([sample(3), sample()])["img"].shape == (4, 4, 4, 3)
    assert PP.collate([None, None]) is None and JP.collate([None, None]) is None


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_contract(workers):
    """torch's DataLoader under the JAX loader's contract: batches as CPU
    tensors equal to `collate` of the sampler's indices, an all-None batch
    skipped, a worker's exception the cause of the error naming the batch;
    no more workers than batches."""
    rng = np.random.default_rng(0)
    items = [{"img": rng.random((4, 4, 3)).astype(np.float32), "i": np.asarray(i)}
             for i in range(6)]
    data = items[:3] + [None, None] + items[3:]
    batches = [[0, 1], [3, 4], [5, 6], [7, 2]]
    loader = PP.DataLoader(data, batches, num_workers=workers, prefetch=1)
    assert len(loader) == 4
    got = list(loader)
    assert len(got) == 3
    for batch, idx in zip(got, ([0, 1], [5, 6], [7, 2])):
        want = PP.collate([data[i] for i in idx])
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        for k in want:
            np.testing.assert_array_equal(batch[k].numpy(), want[k])
    bad = PP.DataLoader(data, [[0, 1], [2, 99]], num_workers=workers)
    it = iter(bad)
    next(it)
    with pytest.raises(RuntimeError, match="loader worker failed on batch 1") as e:
        next(it)
    assert isinstance(e.value.__cause__, IndexError)
    assert PP.DataLoader(data, [[0, 1]], num_workers=workers).loader.num_workers == min(
        workers, 1)


def test_datasets_and_tracks_match_jax(tmp_path):
    """An on-disk FFHQ-layout corpus (pngs + FAN / mediapipe npys) through
    FFHQDataset, the synthetic dataset and the loader's dataset catalog,
    per sample under one seeded Generator; a sample with a missing
    landmark file is None; landmarks_interpolate fills a gappy track."""
    rng = np.random.default_rng(3)
    H = W = 160
    dirs = [tmp_path / n for n in ("ffhq", "fan", "mp")]
    for d in dirs:
        d.mkdir()
    th_mp = np.linspace(0, 2 * np.pi, 478, endpoint=False)
    th_fan = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    for i in range(3):
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
            dirs[0] / f"{i:05d}.png")
        mp = np.stack([W / 2 + 40 * np.cos(th_mp), H / 2 + 50 * np.sin(th_mp)], 1)
        fan = np.stack([W / 2 + 35 * np.cos(th_fan), H / 2 + 45 * np.sin(th_fan)], 1)
        if i != 2:  # the third image has no FAN file
            np.save(dirs[1] / f"{i:05d}.npy", fan[None].astype(np.float32))
        np.save(dirs[2] / f"{i:05d}.npy", mp.astype(np.float32))
    over = ("image_size=64", f"dataset.FFHQ_path={dirs[0]}",
            f"dataset.FFHQ_fan_landmarks_path={dirs[1]}",
            f"dataset.FFHQ_mediapipe_landmarks_path={dirs[2]}")
    cfg, jcfg = load_config(None, over), jax_load_config(None, over)
    pds, jds = PD.FFHQDataset(cfg), JD.FFHQDataset(jcfg)
    assert len(pds) == len(jds) == 3 and pds.items == jds.items
    pairs = [(pds, jds, i) for i in range(3)]
    pairs += [(PD.SyntheticFaceDataset(Config(image_size=64), length=5),
               JD.SyntheticFaceDataset(JaxConfig(image_size=64), length=5), i) for i in (0, 4)]
    for p, j, i in pairs:
        got = p._get(i, np.random.default_rng(10 + i))
        want = j._get(i, np.random.default_rng(10 + i))
        if want is None:
            assert got is None and i == 2
            continue
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    sample = pds[2]  # retries past the broken item
    assert sample["img"].shape == (64, 64, 3) and sample["landmarks_fan"].shape == (68, 2)
    train, val = PP.load_dataloaders(cfg)
    assert val is None and len(train) == cfg.train.samples_per_epoch // cfg.train.batch_size

    track = [None, np.ones((68, 2)), None, None, 4 * np.ones((68, 2)), None]
    got = PTR.landmarks_interpolate(list(track))
    want = JTR.landmarks_interpolate(list(track))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], 2 * np.ones((68, 2)))
    assert PTR.landmarks_interpolate([None, None]) is None
