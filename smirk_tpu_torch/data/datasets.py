"""Dataset catalog: LRS3 / MEAD / MEAD-sides / FFHQ / CelebA + synthetic
(a copy of smirk_tpu/data/datasets.py; numpy, PIL and optionally cv2: the
datasets run in the loader's workers, which must not touch the card).

Mirrors the reference dataset layer (datasets/*.py): per-sample logic =
load frame + FAN/mediapipe landmark files -> prepare_sample; robust retry
with random re-index on any failure (base_dataset.py:102-122). Video decode
uses cv2 when present (not bundled here); image datasets use PIL.

The synthetic dataset generates procedural face-like frames + landmarks so
the full pipeline (and training smoke tests) run with zero external data.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from smirk_tpu_torch.data.base import prepare_sample


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _cv2():
    try:
        import cv2  # type: ignore

        return cv2
    except ImportError as e:
        raise ImportError(
            "video datasets need cv2 for decoding; install opencv or "
            "pre-extract frames"
        ) from e


class FaceDataset:
    """Base: retry-with-random-index on any per-sample failure."""

    name = "base"

    def __init__(self, config, test: bool = False):
        self.config = config
        self.test = test
        self.image_size = config.image_size
        self.scale = (
            config.train.test_scale
            if test
            else [config.train.train_scale_min, config.train.train_scale_max]
        )

    def __len__(self):
        raise NotImplementedError

    def _get(self, index: int, rng: np.random.Generator):
        raise NotImplementedError

    def __getitem__(self, index: int):
        rng = np.random.default_rng()
        for _ in range(100):
            try:
                d = self._get(index, rng)
                if d is not None and d["landmarks_fan"].shape[-2] == 68:
                    return d
            except Exception:
                pass
            index = int(rng.integers(0, len(self)))
        raise RuntimeError(f"{self.name}: no loadable sample after 100 tries")

    def _prepare(self, rng, image, lmk_fan, lmk_mp):
        return prepare_sample(
            rng, image, lmk_fan, lmk_mp,
            image_size=self.image_size, scale=self.scale, test=self.test,
        )


class SyntheticFaceDataset(FaceDataset):
    """Procedural stand-in: ellipse 'face' + consistent landmark clouds."""

    name = "synthetic"

    def __init__(self, config, length: int = 256, test: bool = False, seed=0):
        super().__init__(config, test)
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def _get(self, index, rng):
        r = np.random.default_rng(self.seed * 100003 + index)
        H = W = 320
        cx, cy = r.uniform(120, 200, 2)
        ax, ay = r.uniform(50, 80), r.uniform(65, 95)
        yy, xx = np.mgrid[0:H, 0:W]
        face = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
        img = (r.uniform(0, 60, (H, W, 3)) + face[..., None] * r.uniform(100, 180)
               ).clip(0, 255).astype(np.uint8)
        theta = np.linspace(0, 2 * np.pi, 478, endpoint=False)
        lmk_mp = np.stack(
            [cx + 0.9 * ax * np.cos(theta), cy + 0.9 * ay * np.sin(theta)], 1
        ) + r.normal(0, 1, (478, 2))
        theta2 = np.linspace(0, 2 * np.pi, 68, endpoint=False)
        lmk_fan = np.stack(
            [cx + 0.8 * ax * np.cos(theta2), cy + 0.8 * ay * np.sin(theta2)], 1
        )
        if index % 5 == 4:
            lmk_fan = None  # exercise flag_landmarks_fan=False path
        return self._prepare(rng, img, lmk_fan, lmk_mp)


class FFHQDataset(FaceDataset):
    """Reference datasets/ffhq_dataset.py: png images + per-image npy."""

    name = "FFHQ"

    def __init__(self, config, test=False):
        super().__init__(config, test)
        d = config.dataset
        self.items: List[List[str]] = []
        if os.path.isdir(d.FFHQ_path):
            for image in sorted(os.listdir(d.FFHQ_path)):
                if image.endswith(".png"):
                    stem = image.split(".")[0] + ".npy"
                    self.items.append([
                        os.path.join(d.FFHQ_path, image),
                        os.path.join(d.FFHQ_fan_landmarks_path, stem),
                        os.path.join(d.FFHQ_mediapipe_landmarks_path, stem),
                    ])

    def __len__(self):
        return len(self.items)

    def _get(self, index, rng):
        img_p, fan_p, mp_p = self.items[index]
        if not (os.path.exists(fan_p) and os.path.exists(mp_p)):
            return None
        fan = np.load(fan_p, allow_pickle=True)
        if fan is None or fan.size == 1:
            return None
        return self._prepare(
            rng, _read_image(img_p), fan[0], np.load(mp_p, allow_pickle=True)
        )


class CelebADataset(FaceDataset):
    """Identity-grouped: one random image per identity per epoch sample
    (reference datasets/celeba_dataset.py)."""

    name = "CelebA"

    def __init__(self, config, identity_file: Optional[str] = None, test=False):
        super().__init__(config, test)
        d = config.dataset
        self.groups: Dict[str, List[str]] = {}
        identity_file = identity_file or os.path.join(
            os.path.dirname(d.CelebA_path) or ".", "identity_CelebA.txt"
        )
        if os.path.isfile(identity_file):
            with open(identity_file) as f:
                for line in f:
                    file, subject = line.split()[:2]
                    npy = file.replace(".jpg", ".npy").replace(".png", ".npy")
                    if not os.path.exists(
                        os.path.join(d.CelebA_mediapipe_landmarks_path, npy)
                    ):
                        continue
                    self.groups.setdefault(subject, []).append(file)
        self.keys = list(self.groups)

    def __len__(self):
        return len(self.keys)

    def _get(self, index, rng):
        d = self.config.dataset
        files = self.groups[self.keys[index]]
        if not files:
            return None
        f = files[int(rng.integers(0, len(files)))]
        npy = f.replace(".jpg", ".npy")
        fan_p = os.path.join(d.CelebA_fan_landmarks_path, npy)
        mp_p = os.path.join(d.CelebA_mediapipe_landmarks_path, npy)
        if not (os.path.exists(fan_p) and os.path.exists(mp_p)):
            return None
        fan = np.load(fan_p, allow_pickle=True)
        if fan is None or fan.size == 1:
            return None
        return self._prepare(
            rng,
            _read_image(os.path.join(d.CelebA_path, f)),
            fan[0],
            np.load(mp_p, allow_pickle=True),
        )


class VideoFrameDataset(FaceDataset):
    """Random frame from a video + per-frame landmark tracks.

    Covers LRS3 (fan pkl + mediapipe npy tracks, reference
    datasets/lrs3_dataset.py) and MEAD-style layouts. items: list of
    (video_path, fan_pkl_or_None, mediapipe_npy).

    Temporal sampling (reference declares `K` / `LRS3_temporal_sampling` in
    config but never implements them — configs/config_train.yaml:6,86): with
    temporal=True and config.K > 1, a sample is a window of K CONSECUTIVE
    frames, each cropped from its own tracked landmarks but sharing one
    augmentation draw (same scale/photometric/shift parameters across the
    window), stacked on a leading K axis. The collate folds windows into the
    batch axis (batch-of-windows is still plain data parallelism on the
    mesh — SURVEY §5 long-context row).
    """

    name = "video"

    def __init__(self, config, items: List, test=False, temporal=False):
        super().__init__(config, test)
        self.items = items
        self.K = int(config.K) if (temporal and not test) else 1

    def __len__(self):
        return len(self.items)

    def _get(self, index, rng):
        from smirk_tpu_torch.data.tracks import landmarks_interpolate

        video_p, fan_p, mp_p = self.items[index][:3]
        fan_track = None
        if fan_p is not None:
            with open(fan_p, "rb") as f:
                fan_track = landmarks_interpolate(pickle.load(f))
            if fan_track is None:
                return None
        mp_track = np.load(mp_p)

        cv2 = _cv2()
        cap = cv2.VideoCapture(video_p)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n <= 0:
            cap.release()
            return None
        K = max(1, self.K)
        start = int(rng.integers(0, max(1, n - K + 1)))
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        for _ in range(K):
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(frame[..., ::-1])  # BGR -> RGB
        cap.release()
        if not frames:
            return None
        decoded = len(frames)  # may stop short of the metadata frame count
        while len(frames) < K:  # short-clip tail: repeat last (static shapes)
            frames.append(frames[-1])

        if K == 1:
            fan = fan_track[start] if fan_track is not None else None
            return self._prepare(rng, frames[0], fan, mp_track[start])

        # one augmentation draw shared across the window: same-seeded rng per
        # frame replays identical scale/augment parameters (the crop tform
        # still tracks each frame's own landmarks)
        seed = int(rng.integers(0, 2**31 - 1))
        samples = []
        for t, frame in enumerate(frames):
            # clamp to the last DECODED frame: when cap.read() stops early
            # (corrupt tail, inaccurate CAP_PROP_FRAME_COUNT) the padded
            # frames are copies of frame start+decoded-1 and must carry that
            # frame's landmarks, not later ones
            i = min(start + t, start + decoded - 1, len(mp_track) - 1, n - 1)
            fan = fan_track[i] if fan_track is not None else None
            samples.append(
                self._prepare(np.random.default_rng(seed), frame, fan,
                              mp_track[i])
            )
        return {
            k: np.stack([np.asarray(s[k]) for s in samples])
            for k in samples[0]
        }


def get_lrs3_items(lrs3_path: str, landmarks_path: str, lists_pkl: str):
    """LRS3 train/val/test item lists with the one-time cached list build
    (reference data_utils.py:105-147)."""
    if os.path.exists(lists_pkl):
        with open(lists_pkl, "rb") as f:
            train, val, test = pickle.load(f)
        return (
            [(a, b, c) for a, b, c, *_ in train],
            [(a, b, c) for a, b, c, *_ in val],
            [(a, b, c) for a, b, c, *_ in test],
        )
    raise FileNotFoundError(
        f"{lists_pkl} not found; run tools/build_lrs3_lists.py once"
    )


# --------------------------- MEAD catalog ---------------------------

# the paper's randomly-selected subject split (reference
# datasets/mead_dataset.py:65-68 / mead_sides_dataset.py:53-56)
MEAD_TRAIN_SUBJECTS = [
    "M003", "M007", "M009", "M011", "M012", "M019", "M024", "M025", "M026",
    "M027", "M029", "M030", "M031", "M032", "M033", "M034", "M035", "M037",
    "M039", "M040", "M041", "W009", "W011", "W014", "W015", "W016", "W019",
    "W021", "W023", "W024", "W025", "W026", "W035", "W036", "W037", "W038",
    "W040",
]
MEAD_VAL_SUBJECTS = ["M013", "M023", "M042", "W018", "W028"]
MEAD_TEST_SUBJECTS = ["M005", "M022", "M028", "W029", "W033"]


def get_mead_items(config):
    """Front-view MEAD: (video, fan pkl, mediapipe npy) per clip, split by
    subject (reference mead_dataset.py:61-100)."""
    d = config.dataset
    out = {"train": [], "val": [], "test": []}
    if not os.path.isdir(d.MEAD_fan_landmarks_path):
        return out["train"], out["val"], out["test"]
    for f in sorted(os.listdir(d.MEAD_fan_landmarks_path)):
        subject = f.split("_")[0]
        stem = f.split(".")[0]
        item = (
            os.path.join(d.MEAD_path, stem + ".mp4"),
            os.path.join(d.MEAD_fan_landmarks_path, stem + ".pkl"),
            os.path.join(d.MEAD_mediapipe_landmarks_path, stem + ".npy"),
        )
        if subject in MEAD_TRAIN_SUBJECTS:
            out["train"].append(item)
        elif subject in MEAD_VAL_SUBJECTS:
            out["val"].append(item)
        elif subject in MEAD_TEST_SUBJECTS:
            out["test"].append(item)
    return out["train"], out["val"], out["test"]


def get_mead_sides_items(config):
    """Side-view MEAD (4 views, mediapipe only -> FAN flag False;
    reference mead_sides_dataset.py:51-108)."""
    d = config.dataset
    out = {"train": [], "val": [], "test": []}
    for view in ("videos_left_30", "videos_left_60",
                 "videos_right_30", "videos_right_60"):
        vdir = os.path.join(d.MEAD_sides_path, view)
        if not os.path.isdir(vdir):
            continue
        for f in sorted(os.listdir(vdir)):
            if not f.endswith(".mp4") or "test" in f:
                continue
            subject = f.split("_")[0]
            stem = f.split(".")[0]
            lmk = os.path.join(vdir, stem + ".npy")
            if not os.path.exists(lmk):
                continue
            item = (os.path.join(vdir, f), None, lmk)
            if subject in MEAD_TRAIN_SUBJECTS:
                out["train"].append(item)
            elif subject in MEAD_VAL_SUBJECTS:
                out["val"].append(item)
            elif subject in MEAD_TEST_SUBJECTS:
                out["test"].append(item)
    return out["train"], out["val"], out["test"]
