"""The port's bench line: bench.py's three workloads on one card, printed as
one JSON line.

    python -m smirk_tpu_torch.bench               # the card: b64 / b32 / b64, 224 px
    python -m smirk_tpu_torch.bench --device cpu  # tiny shapes, plumbing only

Workloads (PERF.md section 2's definitions; fp32 unless a field says bf16,
TF32 off inside every entry point, random seeded weights):
  * infer: `SmirkSystem.infer` at b64, 224 px, warm; the median and spread
    (max - min over median) of 5 windows of 50 back-to-back calls, each
    window ended by a synchronize (host clock); the render's coverage must
    exceed 5 %;
  * train: `SmirkSystem.train_step` at b32 on bench.py's synthetic batch
    (the recipe's defaults: generator 32 features / 5 blocks, cycle loss
    on, no teachers), per freeze parity: the median of 3 windows of 5
    steps -> train_ms_batch32_fp32_p0 / _p1 / _avg; then the same with
    `arch.bf16_compute` (bench.py's train fields) -> train_ms_batch32_bf16_*;
    beside each, train_host_ms_*: the calling thread's CPU ms a step;
  * reconstruct: bench.py's one-program form at b64 (pre-cropped random
    224 px images, a box hull, fixed draws): `infer` then
    `SmirkSystem.reconstruct`, the median of 5 windows of 5 calls ->
    reconstruct_fp32_fps / _ms_batch, and with `arch.bf16_compute` ->
    reconstruct_bf16_fps / _ms_batch (bench.py's); beside it `Predictor.reconstruct` on
    seeded 480x640 uint8 frames with landmarks mapped in as chip_smoke's
    phase 5e does (host crop and copy-back included) ->
    predictor_reconstruct_fp32_fps / _ms_batch.

The head: `assets.load_all()` when SMIRK_ASSETS names a root, else
`procedural_bundle(seed=0, full_size=True)`; either is recentred as
bench.py's cam_fix does (random-init cams would render an empty scene).
`tf32` is read inside the entry points (a forward pre-hook on the encoder).

bench.py's guarantees: a flushed provisional line at T=0; each workload in
a child process under a timeout; a global deadline (SMIRK_BENCH_DEADLINE_S,
default 900 s) within which the final line is printed; a measurement that
is missing becomes null with a `<workload>_error` field, and the exit code
is then 1. The last line of the output is the final line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

_T0 = time.monotonic()
WORKLOADS = ("infer", "train", "reconstruct")
FIELDS = {
    "infer": ("infer_fps_b64", "infer_ms_b64", "infer_spread_pct", "infer_coverage"),
    "train": ("train_ms_batch32_fp32_p0", "train_ms_batch32_fp32_p1",
              "train_ms_batch32_fp32_avg", "train_spread_pct",
              "train_ms_batch32_bf16_p0", "train_ms_batch32_bf16_p1",
              "train_ms_batch32_bf16_avg", "train_bf16_spread_pct",
              "train_host_ms_fp32_p0", "train_host_ms_fp32_p1", "train_host_ms_bf16_p0",
              "train_host_ms_bf16_p1"),
    "reconstruct": ("reconstruct_fp32_fps", "reconstruct_fp32_ms_batch",
                    "reconstruct_spread_pct", "predictor_reconstruct_fp32_fps",
                    "predictor_reconstruct_fp32_ms_batch", "reconstruct_bf16_fps",
                    "reconstruct_bf16_ms_batch", "reconstruct_bf16_spread_pct"),
}
# seconds kept back from a child's timeout to print the final line
_RESERVE_S = 2.0
# (windows, calls a window) per workload on the card
WINDOWS = {"infer": (5, 50), "train": (3, 5), "reconstruct": (5, 5)}
FRAME_HW = (480, 640)
CROP_OVER_S = 1.5


def _deadline_s() -> float:
    return float(os.environ.get("SMIRK_BENCH_DEADLINE_S", "900"))


def _remaining() -> float:
    return _deadline_s() - (time.monotonic() - _T0)


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


# ------------------------------- children -------------------------------


class _Setup:
    """Shapes, head and timing of one child: the card's or the CPU's."""

    def __init__(self, device: str):
        import numpy as np
        import torch

        from smirk_tpu_torch import assets
        from smirk_tpu_torch.config import ArchConfig, Config, TrainConfig
        from smirk_tpu_torch.device import resolve_device

        self.cpu = device == "cpu"
        self.device = resolve_device(device)
        if self.cpu:  # plumbing only: tiny shapes, one short window each
            self.S, self.B_infer, self.B_train, self.B_rec = 32, 2, 2, 2
            self.config = Config(image_size=32, arch=ArchConfig(num_expression=10, num_shape=30),
                                 train=TrainConfig(batch_size=2, mask_ratio=0.02,
                                                   mask_dilation_radius=3))
            self.windows = {k: (2, 1) for k in WINDOWS}
        else:
            self.S, self.B_infer, self.B_train, self.B_rec = 224, 64, 32, 64
            self.config = Config()
            self.windows = WINDOWS
        if os.environ.get("SMIRK_ASSETS"):
            bundle, self.head = dict(assets.load_all()), "assets.load_all"
        else:
            bundle = assets.procedural_bundle(seed=0, full_size=not self.cpu)
            self.head = f"procedural_bundle(seed=0, full_size={not self.cpu})"
        # bench.py's cam_fix: the face region recentred onto the optical
        # axis (here in the template: the same translation before the scale)
        vt = np.array(bundle["v_template"], np.float32)
        vt[:, :2] -= vt[np.asarray(bundle["face_vertex_ids"])].mean(0)[:2]
        bundle["v_template"] = vt
        self.bundle = bundle
        self.torch = torch
        self.tf32 = []

    def system(self, arch=None, train=None, **kw):
        """A SmirkSystem on the config with `arch` / `train` fields replaced."""
        import dataclasses

        from smirk_tpu_torch.train.trainer import SmirkSystem

        config = dataclasses.replace(
            self.config, arch=dataclasses.replace(self.config.arch, **(arch or {})),
            train=dataclasses.replace(self.config.train, **(train or {})))
        return self.watch(SmirkSystem(config, self.bundle, device=self.device, **kw))

    def watch(self, system):
        """Record the TF32 flags as every encoder call sees them."""
        backends = self.torch.backends

        def hook(module, args):
            self.tf32.append(bool(backends.cudnn.allow_tf32
                                  or backends.cuda.matmul.allow_tf32))

        system.encoder.register_forward_pre_hook(hook)
        return system

    def sync(self):
        if not self.cpu:
            self.torch.cuda.synchronize()

    def windows_ms(self, name, fn):
        """Sorted ms per call of warm windows of back-to-back calls, each
        window ended by a synchronize (host clock). `host_ms` is then the
        median over the windows of the calling thread's CPU ms per call: near
        the wall time, the host paces the calls."""
        n_windows, n_calls = self.windows[name]
        fn()
        self.sync()
        ms, host = [], []
        for _ in range(n_windows):
            t, c = time.perf_counter(), time.thread_time()
            for _ in range(n_calls):
                fn()
            self.sync()
            ms.append((time.perf_counter() - t) / n_calls * 1e3)
            host.append((time.thread_time() - c) / n_calls * 1e3)
        self.host_ms = statistics.median(host)
        return sorted(ms)

    def fields(self, **kw):
        return {**kw, "tf32": any(self.tf32) if self.tf32 else None,
                "device_name": "cpu" if self.cpu else self.torch.cuda.get_device_name(0),
                "head": self.head}


def _spread(ms):
    return (ms[-1] - ms[0]) / statistics.median(ms) * 100


def measure_infer(st: _Setup) -> dict:
    import numpy as np

    system = st.system()
    img = st.torch.as_tensor(np.random.default_rng(0).random(
        (st.B_infer, st.S, st.S, 3), np.float32), device=st.device)
    coverage = float(system.infer(img)["rendered_mask"].mean())
    if not coverage > 0.05:
        raise RuntimeError(f"benchmark scene is empty (coverage={coverage})")
    ms = st.windows_ms("infer", lambda: system.infer(img))
    med = statistics.median(ms)
    return st.fields(infer_fps_b64=st.B_infer / med * 1e3, infer_ms_b64=med,
                     infer_spread_pct=_spread(ms), infer_coverage=coverage,
                     infer_batch=st.B_infer)


def train_batch(B, S, seed):
    """bench.py's synthetic training batch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((B, S, S, 3), np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (B, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.ones((B,), bool),
        "landmarks_mp": rng.uniform(-1, 1, (B, 105, 2)).astype(np.float32),
        "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32),
        "img_mica": np.zeros((B, 112, 112, 3), np.float32),
    }


def measure_train(st: _Setup) -> dict:
    batch = train_batch(st.B_train, st.S, 0)  # numpy, as chip_smoke's phase 6 times it
    out = {}
    for precision in ("fp32", "bf16"):
        system = st.system(arch={"bf16_compute": precision == "bf16"}, steps_per_epoch=100)
        gen = st.torch.Generator(device=st.device).manual_seed(0)
        spreads = []
        for parity in (0, 1):
            ms = st.windows_ms("train", lambda: system.train_step(batch, parity, gen))
            out[f"train_host_ms_{precision}_p{parity}"] = st.host_ms
            metrics, _ = system.train_step(batch, parity, gen)
            if not all(math.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"non-finite {precision} train metrics at parity "
                                   f"{parity}: {metrics}")
            out[f"train_ms_batch32_{precision}_p{parity}"] = statistics.median(ms)
            spreads.append(_spread(ms))
        out[f"train_ms_batch32_{precision}_avg"] = (
            out[f"train_ms_batch32_{precision}_p0"] + out[f"train_ms_batch32_{precision}_p1"]) / 2
        out["train_spread_pct" if precision == "fp32" else "train_bf16_spread_pct"] = max(spreads)
        del system
    return st.fields(**out, train_batch=st.B_train)


def measure_reconstruct(st: _Setup) -> dict:
    import numpy as np

    from smirk_tpu_torch import Predictor

    torch, S, B = st.torch, st.S, st.B_rec
    system = st.system()
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((B, S, S, 3), np.float32), device=st.device)
    # bench.py's box hull: 1 = background, the face box the centre ~45 %
    hull = torch.ones((B, S, S, 1), device=st.device)
    hull[:, S // 4: -S // 8, S // 4: -S // 4] = 0.0

    def one_program(system):
        def program():
            out = system.infer(img)
            gen = torch.Generator(device=st.device).manual_seed(0)
            return system.reconstruct(out, img, hull, gen)[1], out["rendered_mask"]

        recon, mask = program()
        coverage = float(mask.mean())
        if not (coverage > 0.05 and bool(torch.isfinite(recon).all())):
            raise RuntimeError(f"reconstruct scene is empty or not finite ({coverage})")
        return st.windows_ms("reconstruct", program)

    ms = one_program(system)
    med = statistics.median(ms)
    ms_bf16 = one_program(st.system(arch={"bf16_compute": True}))
    med_bf16 = statistics.median(ms_bf16)

    pred = Predictor(use_generator=True, device=st.device, bundle=st.bundle, config=st.config)
    pred.system.encoder.load_state_dict(system.encoder.state_dict())
    st.watch(pred.system)
    # seeded frames, each with the b-th render's landmarks mapped in about
    # the frame's centre so the scale-1.4 crop is CROP_OVER_S x S px
    FH, FW = FRAME_HW if not st.cpu else (2 * S, 3 * S)
    frames = rng.integers(0, 256, (B, FH, FW, 3), dtype=np.uint8)
    lmk = system.infer(img)["landmarks_mp"][..., :2].cpu().numpy()
    bbox = np.ptp(lmk, axis=1).mean() * S / 2
    lmks = lmk * (S / 2 * CROP_OVER_S * S / (1.4 * bbox)) + np.float32([FW / 2, FH / 2])
    ms_p = st.windows_ms("reconstruct", lambda: pred.reconstruct(frames, lmks))
    med_p = statistics.median(ms_p)
    return st.fields(reconstruct_fp32_fps=B / med * 1e3, reconstruct_fp32_ms_batch=med,
                     reconstruct_spread_pct=_spread(ms),
                     predictor_reconstruct_fp32_fps=B / med_p * 1e3,
                     predictor_reconstruct_fp32_ms_batch=med_p,
                     reconstruct_bf16_fps=B / med_bf16 * 1e3, reconstruct_bf16_ms_batch=med_bf16,
                     reconstruct_bf16_spread_pct=_spread(ms_bf16), reconstruct_batch=B)


def measure_train_options(st: _Setup) -> dict:
    """The training options' steps beside the plain fp32 one, in one child
    (not part of the line; chip_smoke's phase 5j reads it): fp32,
    `arch.bf16_cycle_frozen` and `train.remat_cycle`, each per parity the
    train workload's windows, the calling thread's CPU ms a step, and the
    peak memory of one step (max_memory_allocated; None on the CPU)."""
    batch = train_batch(st.B_train, st.S, 0)
    out = {}
    for name, arch, train in (("fp32", {}, {}), ("cycle_frozen", {"bf16_cycle_frozen": True}, {}),
                              ("remat", {}, {"remat_cycle": True})):
        system = st.system(arch=arch, train=train, steps_per_epoch=100)
        gen = st.torch.Generator(device=st.device).manual_seed(0)
        for parity in (0, 1):
            ms = st.windows_ms("train", lambda: system.train_step(batch, parity, gen))
            out[f"train_ms_batch32_{name}_p{parity}"] = statistics.median(ms)
            out[f"train_{name}_spread_pct_p{parity}"] = _spread(ms)
            out[f"train_host_ms_{name}_p{parity}"] = st.host_ms
            if not st.cpu:
                st.torch.cuda.reset_peak_memory_stats()
            metrics, _ = system.train_step(batch, parity, gen)
            st.sync()
            out[f"peak_mb_{name}_p{parity}"] = (
                None if st.cpu else st.torch.cuda.max_memory_allocated() / 2 ** 20)
            if not all(math.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"non-finite {name} train metrics at parity {parity}: "
                                   f"{metrics}")
        del system
    return st.fields(**out, train_batch=st.B_train)


MEASURE = {"infer": measure_infer, "train": measure_train,
           "reconstruct": measure_reconstruct, "train_options": measure_train_options}


# -------------------------------- parent --------------------------------


def _child(name: str, device) -> dict:
    """One workload in a child process under the deadline -> its fields,
    or {name_error: why}."""
    budget = _remaining() - _RESERVE_S
    if budget <= 0:
        return {f"{name}_error": "skipped (deadline)"}
    cmd = [sys.executable, "-m", "smirk_tpu_torch.bench", "--inner", name]
    if device:
        cmd += ["--device", device]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=budget)
        out, tail = proc.stdout, (proc.stderr or proc.stdout)[-300:]
    except subprocess.TimeoutExpired:
        return {f"{name}_error": f"timeout after {budget:.1f} s"}
    for line in reversed(out.splitlines()):
        if line.startswith("{"):
            try:
                fields = json.loads(line)
            except ValueError:
                return {f"{name}_error": f"unreadable line: {line[:200]}"}
            if proc.returncode != 0:
                fields[f"{name}_error"] = f"child rc={proc.returncode}: {tail}"
            return fields
    return {f"{name}_error": f"child rc={proc.returncode}, no line: {tail}"}


def _line(results: dict, smi: str, provisional: bool) -> dict:
    line = {"bench": "smirk_tpu_torch", "provisional": provisional}
    for name in WORKLOADS:
        for f in FIELDS[name]:
            line[f] = results.get(f)
    for name in WORKLOADS:
        line[f"{name}_batch"] = results.get(f"{name}_batch")
    line["tf32"] = results.get("tf32")
    line["device_name"] = results.get("device_name")
    line["nvidia_smi"] = smi
    line["head"] = results.get("head")
    line.update({k: v for k, v in results.items() if k.endswith("_error")})
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu: tiny shapes on the CPU (default: the card)")
    ap.add_argument("--inner", choices=tuple(MEASURE), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.inner:
        print(json.dumps(MEASURE[args.inner](_Setup(args.device))), flush=True)
        return 0

    smi = "cpu" if args.device == "cpu" else nvidia_smi()
    print(json.dumps(_line({}, smi, True)), flush=True)
    results, tf32 = {}, []
    for name in WORKLOADS:
        fields = _child(name, args.device)
        if "tf32" in fields:
            tf32.append(fields.pop("tf32"))
        results.update(fields)
    if tf32:
        results["tf32"] = any(v for v in tf32 if v is not None)
    line = _line(results, smi, False)
    missing = [f for name in WORKLOADS for f in FIELDS[name] if line[f] is None]
    if missing and not any(k.endswith("_error") for k in line):
        line["error"] = f"missing {missing}"
    print(json.dumps(line), flush=True)
    ok = not missing and line["tf32"] is False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
