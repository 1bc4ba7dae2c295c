"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface, at first use, into `smirk_tpu_torch/build/`
(listed in .gitignore), and loaded with ctypes. The sources include the
shared headers of csrc/ (`window_raster.cuh`); a library is rebuilt when
its source or any header is newer. `build()` compiles all
stale sources at once, one `nvcc` process per source started together.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> (source file, {C function: argtypes})
LIBRARIES = {
    "raster_fused": ("raster_fused.cu", {
        # kept, bins, records, face_verts, p2f, zbuf, nx, ny, nz,
        # B, Tp, C, F, H, W, TX, grid radius, device, stream
        "smirk_raster_fused_windows": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    }),
    "raster_planes": ("raster_planes.cu", {
        # kept, bins, records, face_verts, p2f, zbuf, slot, vals,
        # B, Tp, C, F, H, W, TX, D, grid radius, device, stream
        "smirk_raster_planes_windows": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    }),
    "segment_moments": ("segment_moments.cu", {
        # slots, g, out, B, Tp, C, D, group, H, W, TX, device, stream
        "smirk_segment_moments": [_P] * 3 + [_I] * 9 + [_P],
        # slots, g, bins, out, B, Tp, C, D, group, H, W, TX, F, device, stream
        "smirk_segment_moments_to_faces": [_P] * 4 + [_I] * 10 + [_P],
        "smirk_max_shared_optin": [_I],  # device
    }),
    "fold_faces": ("fold_faces.cu", {
        # per_slot, bins, out, B, rows (an image's slot rows), CHN, F, vec,
        # device, stream
        "smirk_fold_faces": [_P] * 3 + [_I] * 6 + [_P],
    }),
    "raster_coverage": ("raster_coverage.cu", {
        # kept, bins, records, face_verts, p2f, zbuf, slot,
        # B, Tp, C, F, H, W, TX, grid radius, device, stream
        "smirk_raster_coverage_windows": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    }),
    "segment_reduce": ("segment_reduce.cu", {
        # slots, payload, out, B, Tp, C, CHN, group, span, device, stream
        "smirk_segment_reduce_tiles": [_P] * 3 + [_I] * 7 + [_P],
        "smirk_max_shared_optin": [_I],  # device
    }),
    "raster_bins": ("raster_bins.cu", {
        # counts, bins, fv, p2f, zbuf, B, Tp, T, C, F, H, W, TX, grid radius,
        # device, stream
        "smirk_raster_bins_coverage": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    }),
    "raster_groups": ("raster_groups.cu", {
        # counts, recs, p2f, zbuf, nx, ny, nz,
        # B, Tp, C, tps, per_pass, local, H, W, TX, device, stream
        "smirk_raster_fused_groups": [_P] * 7 + [_I] * 10 + [_P],
        "smirk_max_shared_optin": [_I],  # device
    }),
    "raster_chunkskip": ("raster_chunkskip.cu", {
        # counts, clist, recs, p2f, zbuf, nx, ny, nz,
        # B, Tp, cap, F, CH, H, W, TX, device, stream
        "smirk_raster_chunkskip": [_P] * 8 + [_I] * 9 + [_P],
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str):
    source = os.path.join(CSRC_DIR, LIBRARIES[name][0])
    return source, os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Whether library `name` is missing or older than its source or any
    header in csrc/ (a source includes the shared headers by name)."""
    source, lib = _paths(name)
    if not os.path.isfile(lib):
        return True
    inputs = [source] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in inputs)


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, dict]:
    """Compile the named libraries (default: all) that are stale, all
    `nvcc` processes at once. -> {name: {"seconds", "log"}} for each
    library compiled; `log` holds ptxas's register/shared-memory/spill
    report. Raises with the compiler output if any build fails."""
    names = list(LIBRARIES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        source, lib = _paths(n)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    report, failed = {}, []
    for n, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, argtypes in LIBRARIES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.smirk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.smirk_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def error_string(code: int) -> str:
    for lib in _loaded.values():
        return lib.smirk_cuda_error_string(code).decode()
    return "unknown"


def graph_ms(fn, calls: int) -> float:
    """Device ms per call of `fn` on the current CUDA stream: `calls` calls
    captured in one CUDA graph and replayed, so that no host time lies
    between their launches (their output allocations and fills included).
    Every kernel wrapper of the port can be captured; a call that cannot
    raises torch's RuntimeError."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls
