"""Serving export: the inference step as a `torch.export` artifact (port of
smirk_tpu/serving.py).

Packages `image batch -> {params, vertices, landmarks, rendered image}`
(`SmirkSystem.infer`'s body, `infer_body`) as an `ExportedProgram` with the
weights in it, saved with `torch.export.save` (`<path>.pt2`) beside a JSON
sidecar (`<path>.pt2.json`). A serving host loads and calls it with
`load_inference` without the model's Python (no `SmirkSystem`, encoders or
FLAME are imported); it needs torch and the port's op module, which
registers K1 as the custom op the program calls
(`render.rasterizer.K1_OP`). The JAX package's artifact is a
self-contained StableHLO blob; this one is tied to the torch that wrote it
(the sidecar records its version) and to the platform it was exported on
(`platforms`: `cuda` or `cpu`).

Shapes are static: export one artifact per serving batch size and let
`InferenceServer` chunk requests to it. A call runs under
`torch.inference_mode()` and `device.fp32_math()`: a program's cuDNN
convolutions read the process's global TF32 flags, so the pin is what keeps
a served artifact fp32.

The binning mode (`rasterizer.set_bin_mode`) and the fold mode
(`rasterizer.set_fold_mode`) are process globals that the Python code
reads at each call; an artifact holds the ops of the mode set when it was
exported, as the JAX package's holds the mode set when it was traced, and
a later `set_bin_mode` does not reach it.

Differences from the JAX package, by design:
  * the weights live in the system, so the export functions take the
    system alone (no encoder / generator variables) and export on the
    system's device (no `platforms` argument);
  * the reconstruct artifact takes its draws as inputs (`u`, `bary`,
    `rsing`, `rscale`, `noise`, `drop_centers`: `masking.reconstruct_draws`)
    in place of a PRNG key: a `torch.Generator` cannot be an input of an
    exported program, and torch and JAX streams never match anyway;
  * the sharded artifact is the per-device program at `batch // n`;
    `load_inference` places one replica on each of `devices` and splits
    the batch over them. Exporting it needs no devices.
"""
from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from smirk_tpu_torch.device import fp32_math
from smirk_tpu_torch.masking.masking import RECONSTRUCT_DRAWS, reconstruct_draws
from smirk_tpu_torch.render import rasterizer  # noqa: F401  (registers K1's op)

ARTIFACT_SUFFIX = ".pt2"
META_SUFFIX = ".json"

OUTPUT_KEYS = (
    "pose_params", "cam", "shape_params", "expression_params",
    "eyelid_params", "jaw_params", "vertices", "landmarks_fan",
    "landmarks_mp", "rendered_img", "rendered_mask",
    # (B,) int32: compact-raster chunks dropped past the budget, plus the
    # binning's selection misses where the check is armed; 0 = exact
    "raster_overflow",
)
RECONSTRUCT_OUTPUTS = OUTPUT_KEYS + ("masked_img", "reconstructed_img")


class _Served(nn.Module):
    """The modules a served body runs under one root, so that an export
    finds their parameters and buffers (and no others: the inference
    artifact holds no generator); `forward` runs the system's own bodies."""

    def __init__(self, system, *names):
        super().__init__()
        for name in names:
            setattr(self, name, getattr(system, name))
        self.system = system  # not a module: a plain attribute


class _InferenceModule(_Served):
    def __init__(self, system):
        super().__init__(system, "encoder", "flame", "renderer")

    def forward(self, img):
        out = self.system.infer_body(img)
        return {k: out[k] for k in OUTPUT_KEYS if k in out}


class _ReconstructModule(_Served):
    def __init__(self, system):
        super().__init__(system, "encoder", "flame", "renderer", "generator")

    def forward(self, img, hull, u, bary, rsing, rscale, noise, drop_centers):
        out = self.system.infer_body(img)
        draws = dict(zip(RECONSTRUCT_DRAWS, (u, bary, rsing, rscale, noise, drop_centers)))
        masked, recon = self.system.reconstruct_body(out, img, hull, draws)
        keep = {k: out[k] for k in OUTPUT_KEYS if k in out}
        return {**keep, "masked_img": masked, "reconstructed_img": recon}


def make_inference_fn(system) -> nn.Module:
    """img (B,S,S,3) -> the OUTPUT_KEYS of `SmirkSystem.infer`, as a module
    over the system's weights (the encoder in eval mode). It runs
    `infer_body`, the body `infer` runs, without `infer`'s pins: the caller
    (or `load_inference`) sets grad mode and precision."""
    system.encoder.eval()
    return _InferenceModule(system)


def make_reconstruct_fn(system) -> nn.Module:
    """(img, hull, u, bary, rsing, rscale, noise, drop_centers) -> the
    OUTPUT_KEYS + masked_img, reconstructed_img: infer, then
    `SmirkSystem.reconstruct`'s body on the given draws (the same code the
    Predictor API and the demos run). hull (B,S,S,1) is the convex-hull
    background mask, 1 = background; the draws are
    `masking.reconstruct_draws`'."""
    if system.generator is None:
        raise ValueError("reconstruct needs the fuse generator (arch.enable_fuse_generator)")
    system.encoder.eval()
    system.generator.eval()
    return _ReconstructModule(system)


def _artifact_path(path: str) -> str:
    return path if path.endswith(ARTIFACT_SUFFIX) else path + ARTIFACT_SUFFIX


def _export_artifact(system, module: nn.Module, args: Sequence[torch.Tensor],
                     batch_size: int, path: str, extra_meta: Optional[dict] = None,
                     outputs: Sequence[str] = OUTPUT_KEYS) -> str:
    """Shared export tail: `torch.export.export(strict=False)` of `module` on
    `args` (static shapes) under no_grad, `torch.export.save` to
    `<path>.pt2`, and the sidecar `<path>.pt2.json`."""
    size = system.config.image_size
    with torch.no_grad():
        program = torch.export.export(module, tuple(args), strict=False)
    path = _artifact_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    meta = {
        "input": {"shape": [batch_size, size, size, 3], "dtype": "float32",
                  "layout": "NHWC", "range": "[0, 1] RGB"},
        "outputs": list(outputs),
        "platforms": [system.device.type],
        "device": str(system.device),
        "torch": torch.__version__,
        "kind": "inference",
        **(extra_meta or {}),
        "bytes": os.path.getsize(path),
    }
    with open(path + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _example_image(system, batch: int) -> torch.Tensor:
    S = system.config.image_size
    return torch.zeros((batch, S, S, 3), dtype=torch.float32, device=system.device)


def export_inference(system, path: str, batch_size: int = 8) -> str:
    """Export the inference step at `batch_size` on the system's device to
    `path` (+ `.pt2`, and the sidecar metadata json) -> the artifact's
    path."""
    return _export_artifact(system, make_inference_fn(system),
                            (_example_image(system, batch_size),), batch_size, path)


def export_inference_sharded(system, path: str, batch_size: int = 64,
                             n_devices: int = 8) -> str:
    """Data-parallel export: the artifact serves `batch_size` images split
    evenly over `n_devices` replicas. It holds the per-device program at
    `batch_size // n_devices` and records the device count and the 1-D
    `data` mesh; `load_inference` places the replicas. Inference is
    batch-parallel end to end, so the replicas exchange nothing."""
    if batch_size % n_devices:
        raise ValueError("batch_size must divide evenly across devices "
                         f"({batch_size} over {n_devices})")
    per_device = batch_size // n_devices
    return _export_artifact(
        system, make_inference_fn(system), (_example_image(system, per_device),),
        batch_size, path,
        extra_meta={"nr_devices": n_devices, "device_batch": per_device,
                    "mesh": {"axes": ["data"], "shape": [n_devices]}})


def export_reconstruct(system, path: str, batch_size: int = 8) -> str:
    """Export the analysis-by-neural-synthesis reconstruction (encode ->
    render -> mesh-anchored hints -> hull mask -> fuse generator). Inputs:
    img (B,S,S,3) f32 in [0,1], hull (B,S,S,1) f32 background mask (1 =
    background), then the draws of `masking.reconstruct_draws` at the
    config's n_upper (the sidecar lists each input's name, shape and
    dtype)."""
    S = system.config.image_size
    n_upper, _ = system._reconstruct_budget()
    img = _example_image(system, batch_size)
    hull = torch.ones((batch_size, S, S, 1), dtype=torch.float32, device=system.device)
    gen = torch.Generator(device=system.device).manual_seed(0)
    draws = reconstruct_draws(batch_size, n_upper, S, gen, system.device)
    extra = [{"name": "hull", "shape": list(hull.shape), "dtype": "float32",
              "note": "1 = background"}]
    extra += [{"name": k, "shape": list(draws[k].shape),
               "dtype": str(draws[k].dtype).replace("torch.", "")}
              for k in RECONSTRUCT_DRAWS]
    return _export_artifact(
        system, make_reconstruct_fn(system),
        (img, hull, *(draws[k] for k in RECONSTRUCT_DRAWS)), batch_size, path,
        extra_meta={"kind": "reconstruct", "extra_inputs": extra,
                    "n_upper": n_upper, "image_size": S},
        outputs=RECONSTRUCT_OUTPUTS)


def _read_meta(path: str) -> dict:
    with open(path + META_SUFFIX) as f:
        return json.load(f)


def load_inference(path: str, devices: Optional[Sequence] = None) -> Callable:
    """Load an artifact into a callable `(img, *extra) -> {name: tensor}`
    (no model code is imported). Each call converts its inputs to tensors
    on the artifact's device and runs the program under
    `torch.inference_mode()` and `device.fp32_math()`.

    devices: where the replicas go; default the first `nr_devices` CUDA
    devices for a `cuda` artifact, the CPU for a `cpu` one. A `cuda`
    artifact raises on a host without a card (it never runs on the CPU).
    A sharded artifact places one replica on each of the first
    `nr_devices` of `devices`, splits every input's batch over them and
    concatenates the outputs on the first; it raises ValueError when there
    are fewer devices. The callable carries `.device` (the first),
    `.meta` (the sidecar) and `.modules` (the replicas' graph modules)."""
    path = _artifact_path(path)
    meta = _read_meta(path)
    platform = meta["platforms"][0]
    n = int(meta.get("nr_devices", 1))
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for cuda and this host has no CUDA "
                           "device; it does not run on the CPU")
    if devices is None:
        devices = (["cuda:%d" % i for i in range(torch.cuda.device_count())]
                   if platform == "cuda" else ["cpu"])
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type != platform:
            raise ValueError(f"a {platform} artifact cannot run on {d}")
    if len(devices) < n:
        raise ValueError(f"artifact was exported for {n} devices; host has {len(devices)}")
    devices = devices[:n]
    program = torch.export.load(path)
    home = torch.device(meta["device"])
    replicas = []
    for d in devices:
        if (d.type, d.index or 0) != (home.type, home.index or 0):
            from torch.export.passes import move_to_device_pass

            replicas.append(move_to_device_pass(program, d).module())
        else:
            replicas.append(program.module())

    def place(a, d, first: bool):
        t = torch.as_tensor(a, device=d)
        return t.to(torch.float32) if first else t

    def call(img, *rest):
        with torch.inference_mode(), fp32_math():
            if n == 1:
                return replicas[0](place(img, devices[0], True),
                                   *(place(a, devices[0], False) for a in rest))
            m = len(img) // n
            parts = []
            for i, (replica, d) in enumerate(zip(replicas, devices)):
                lo, hi = i * m, (i + 1) * m
                parts.append(replica(place(img[lo:hi], d, True),
                                     *(place(a[lo:hi], d, False) for a in rest)))
            return {k: torch.cat([p[k].to(devices[0]) for p in parts]) for k in parts[0]}

    call.device, call.meta, call.modules = devices[0], meta, replicas
    return call


class InferenceServer:
    """Request-level wrapper over a loaded artifact: accepts any batch size
    by chunking to the exported batch (the tail padded with zero images and
    all-ones hulls, the outputs trimmed) and returns numpy. Concurrent
    calls from the threads of the HTTP server are fine: each runs inside
    its own fp32 pin (`load_inference`)."""

    def __init__(self, artifact_path: str):
        artifact_path = _artifact_path(artifact_path)
        self.call = load_inference(artifact_path)
        self.meta = self.call.meta
        self.batch = int(self.meta["input"]["shape"][0])
        self.input_shape = tuple(self.meta["input"]["shape"][1:])
        self.kind = self.meta.get("kind", "inference")

    def predict(self, img: np.ndarray, hull: Optional[np.ndarray] = None,
                seed: int = 0) -> Dict[str, np.ndarray]:
        """Run the artifact over any batch size (chunk + pad + trim).

        Reconstruct artifacts also need `hull` (N,H,W,1) background masks
        (1 = background) and take a `seed`: chunk `ci` draws its inputs
        (`masking.reconstruct_draws`) from a generator on the artifact's
        device seeded with (seed + ci) mod 2^64, so identical chunks draw
        distinct budgets, and the chunk equals `SmirkSystem.reconstruct`
        with that generator.
        """
        img = np.asarray(img, np.float32)
        if img.shape[1:] != self.input_shape:
            raise ValueError(
                f"input shape {img.shape[1:]} != exported {self.input_shape}")
        n = img.shape[0]
        if n == 0:
            raise ValueError("empty batch: need at least one image")
        if self.kind == "reconstruct":
            if hull is None:
                raise ValueError(
                    "reconstruct artifact needs `hull` (N,H,W,1) background "
                    "masks (1 = background; data.transforms.convex_hull_mask)")
            hull = np.asarray(hull, np.float32)
            if hull.shape != img.shape[:3] + (1,):
                raise ValueError(f"hull shape {hull.shape} != {img.shape[:3] + (1,)}")
        chunks = []
        for ci, lo in enumerate(range(0, n, self.batch)):
            part = img[lo: lo + self.batch]
            pad = self.batch - part.shape[0]
            if pad:
                part = np.concatenate([part, np.zeros((pad,) + self.input_shape, np.float32)])
            if self.kind == "reconstruct":
                hpart = hull[lo: lo + self.batch]
                if pad:
                    hpart = np.concatenate([hpart, np.ones((pad,) + hpart.shape[1:],
                                                           np.float32)])
                dev = self.call.device
                gen = torch.Generator(device=dev).manual_seed(
                    (int(seed) + ci) & 0xFFFFFFFFFFFFFFFF)
                draws = reconstruct_draws(self.batch, int(self.meta["n_upper"]),
                                          int(self.meta["image_size"]), gen, dev)
                out = self.call(part, hpart, *(draws[k] for k in RECONSTRUCT_DRAWS))
            else:
                out = self.call(part)
            chunks.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([c[k] for c in chunks])[:n] for k in chunks[0]}


def create_http_server(artifact_path: str, host: str = "0.0.0.0", port: int = 8000):
    """Serving daemon over the stdlib http server.

    Protocol (the JAX package's):
      GET  /healthz  -> 200 "ok" (readiness probe)
      GET  /meta     -> the artifact's sidecar metadata json
      POST /predict  -> body: npz with key "img" (N,H,W,3) float32 in [0,1]
                        (+ "hull" (N,H,W,1) and optional scalar "seed" for
                        reconstruct artifacts);
                        response: npz of the artifact's output arrays
    A request that fails gets 400 with the error's message; the server
    stays up. Returns the ThreadingHTTPServer (the caller runs
    serve_forever()), with `.inference` the InferenceServer."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    server_obj = InferenceServer(artifact_path)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/meta":
                self._send(200, json.dumps(server_obj.meta).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)))
                out = server_obj.predict(
                    data["img"],
                    hull=data["hull"] if "hull" in data else None,
                    seed=int(data["seed"]) if "seed" in data else 0)
                buf = io.BytesIO()
                np.savez(buf, **out)
                self._send(200, buf.getvalue())
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(400, str(e).encode(), "text/plain")

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.inference = server_obj
    return srv
