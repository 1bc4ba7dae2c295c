"""ctypes bindings of the native host-ops library (`libfastops.so`), the
loader's warps, CLAHE and hull fill (port of smirk_tpu/native/__init__.py).

`fastops.cpp` (a copy of the JAX package's, the same code) is compiled by
`g++` at first use into `smirk_tpu_torch/build/` (listed in .gitignore) with
the JAX package's flags (`tools/build_native.sh`: -ffp-contract=off keeps
GCC's fma contraction from moving double roundings at exact .5 ties, which
the bitwise CLAHE oracle needs), and rebuilt when the source is newer. The
compiler writes a per-process `.tmp` file that `os.replace` moves into
place, so concurrent builders (the loader's spawned workers) never load a
partial library; `load_dataloaders` builds it in the main process before
any worker starts. A failed build, or no `g++`, raises with the compiler's
output: there is no silent numpy fallback (the JAX package's `load()`
returns None). The numpy functions of `smirk_tpu_torch.data.transforms`
(`warp_affine_np`, `_warp_affine_nearest_np`, `convex_hull_mask_np`,
`_clahe_np`, `_clahe_apply_u8`) are the oracles the tests hold this
library to. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fastops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libfastops.so")
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-pthread"]

_F, _D, _U8, _I = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int)
# C function -> argtypes (fastops.cpp's extern "C" block)
_SIGNATURES = {
    # img, H, W, C, minv (2x3), out, OH, OW
    "warp_affine_bilinear": [_F, _I, _I, _I, _D, _F, _I, _I],
    "warp_affine_nearest": [_F, _I, _I, _I, _D, _F, _I, _I],
    # channel, H, W, clip limit, tiles y, tiles x, out
    "clahe_u8": [_U8, _I, _I, ctypes.c_double, _I, _I, _U8],
    "clahe_rgb_f32": [_F, _I, _I, ctypes.c_double, _I, _I, _F],
    # points (N,2) f64, N, mask, H, W
    "convex_hull_mask": [_D, _I, _F, _I, _I],
    # imgs, H, W, C, minvs (N,6), out, OH, OW, N, threads
    "warp_affine_batch": [_F, _I, _I, _I, _D, _F, _I, _I, _I, _I],
    # points (N,K,2) f64, K, masks, H, W, N, threads
    "convex_hull_mask_batch": [_D, _I, _F, _I, _I, _I, _I],
}

_lib = None


def _stale() -> bool:
    return (not os.path.isfile(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE))


def build(force: bool = False) -> Dict[str, object]:
    """Compile fastops.cpp when the library is missing or older than it
    (or `force`) -> {"seconds", "log"} of the compile, {} when up to date.
    Raises RuntimeError with the compiler's output when g++ is missing or
    fails."""
    if not force and not _stale():
        return {}
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host ops (libfastops) are built "
                           "with g++ at first use; install it or put it on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees a partial file
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def load() -> ctypes.CDLL:
    """The loaded library, built first if stale."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = None
        _lib = lib
    return _lib


def _p(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _minv(M: np.ndarray) -> np.ndarray:
    """The 2x3 top of the inverse of a forward 3x3 matrix, row-major f64."""
    return np.ascontiguousarray(np.linalg.inv(np.asarray(M, np.float64))[:2].reshape(-1))


def warp_affine(image: np.ndarray, M: np.ndarray, out_shape: Tuple[int, int]) -> np.ndarray:
    """Bilinear warp of one (H,W,C) image through its FORWARD 3x3 matrix M,
    zero outside (`transforms.warp_affine_np`'s function)."""
    img = np.ascontiguousarray(image, np.float32)
    H, W, C = img.shape
    OH, OW = out_shape
    out = np.empty((OH, OW, C), np.float32)
    load().warp_affine_bilinear(_p(img, _F), H, W, C, _p(_minv(M), _D), _p(out, _F), OH, OW)
    return out


def warp_affine_nearest(image: np.ndarray, M: np.ndarray,
                        out_shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour warp, floor(v + 0.5), zero outside
    (`transforms._warp_affine_nearest_np`'s function)."""
    img = np.ascontiguousarray(image, np.float32)
    H, W, C = img.shape
    OH, OW = out_shape
    out = np.empty((OH, OW, C), np.float32)
    load().warp_affine_nearest(_p(img, _F), H, W, C, _p(_minv(M), _D), _p(out, _F), OH, OW)
    return out


def clahe_u8(channel: np.ndarray, clip_limit: float,
             tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE of a (H,W) uint8 channel (`transforms._clahe_apply_u8`'s
    function, cv2's algorithm)."""
    ch = np.ascontiguousarray(channel, np.uint8)
    H, W = ch.shape
    out = np.empty((H, W), np.uint8)
    load().clahe_u8(_p(ch, _U8), H, W, float(clip_limit), int(tiles[0]), int(tiles[1]),
                    _p(out, _U8))
    return out


def clahe_rgb(image: np.ndarray, clip_limit: float,
              tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """The whole CLAHE augmentation of a (H,W,3) float32 sRGB image in
    [0, 1]: u8 quantization, Lab, CLAHE on L, back (`transforms._clahe_np`'s
    function)."""
    img = np.ascontiguousarray(image, np.float32)
    H, W, C = img.shape
    if C != 3:
        raise ValueError(f"clahe_rgb takes (H,W,3) images, not {img.shape}")
    out = np.empty((H, W, 3), np.float32)
    load().clahe_rgb_f32(_p(img, _F), H, W, float(clip_limit), int(tiles[0]), int(tiles[1]),
                         _p(out, _F))
    return out


def _int_points(points: np.ndarray) -> np.ndarray:
    """Coordinates truncated to int32 as the reference's create_mask does,
    as contiguous float64."""
    return np.ascontiguousarray(np.asarray(points)[..., :2].astype(np.int32).astype(np.float64))


def convex_hull_mask(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """1 outside the convex hull of the (N,2+) points, 0 inside, on an
    (H,W) grid (`transforms.convex_hull_mask_np`'s function)."""
    pts = _int_points(points)
    H, W = shape
    mask = np.empty((H, W), np.float32)
    load().convex_hull_mask(_p(pts, _D), len(pts), _p(mask, _F), H, W)
    return mask


def warp_affine_batch(images: np.ndarray, Ms: np.ndarray, out_shape: Tuple[int, int],
                      n_threads: int = 0) -> np.ndarray:
    """`warp_affine` of (N,H,W,C) images through (N,3,3) forward matrices
    on the library's thread pool (n_threads 0 = the hardware's)."""
    imgs = np.ascontiguousarray(images, np.float32)
    N, H, W, C = imgs.shape
    OH, OW = out_shape
    minvs = np.ascontiguousarray(np.stack([_minv(m) for m in Ms]))
    out = np.empty((N, OH, OW, C), np.float32)
    load().warp_affine_batch(_p(imgs, _F), H, W, C, _p(minvs, _D), _p(out, _F), OH, OW, N,
                             n_threads)
    return out


def convex_hull_mask_batch(points: np.ndarray, shape: Tuple[int, int],
                           n_threads: int = 0) -> np.ndarray:
    """`convex_hull_mask` of (N,K,2+) point sets -> (N,H,W) on the
    library's thread pool."""
    pts = _int_points(points)
    N, K = pts.shape[:2]
    H, W = shape
    masks = np.empty((N, H, W), np.float32)
    load().convex_hull_mask_batch(_p(pts, _D), K, _p(masks, _F), H, W, N, n_threads)
    return masks
