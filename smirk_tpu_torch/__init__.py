"""smirk_tpu_torch: the PyTorch/CUDA port of smirk_tpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never JAX or smirk_tpu. Public functions keep the JAX
package's layout (NHWC images in [0,1], the same output dict keys).

Layout:
  config.py, assets.py  copies of the host-side loaders + procedural_bundle
  flame/                FLAME blendshapes + LBS + landmarks
  models/               MobileNetV3-minimal encoders, the fuse generator
  render/               camera, geometry, shading, rasterizer (inference
                        and differentiable), renderer
  masking/, losses/     mesh-anchored pixel hints and masks; the losses
  csrc/                 CUDA kernels (sm_90a), built by kernels.py
  train/                SmirkSystem: infer, reconstruct, the two-path
                        train_step, eval_step, make_visualizations (each
                        in exact fp32: device.fp32_math)
  data/                 the landmark crop (batched warp) and hull mask;
                        the training samples, datasets and loader
  native/               the loader's host ops (warps, CLAHE, hull fill):
                        fastops.cpp, built with g++ at first use
  parallel/             data-parallel training over torch.distributed;
                        dryrun, its CPU rehearsal
  ops/                  the kernel-level op namespace (the rasterizers,
                        geometry, masking, FLAME math, shading)
  utils/                weight conversion, checkpoints (the one model
                        reader), the metric log, profiling, visualisation,
                        MJPEG-AVI IO
  cli/                  the training CLI and its supervisor, the image and
                        video demos, the serving CLIs, check_parity, the
                        mediapipe wrapper
  examples/             predict, expression_edit, reconstruct
  api.py                Predictor (resize or landmark crop; reconstruct)
  serving.py            torch.export artifacts (inference, sharded,
                        reconstruct), load_inference, InferenceServer, the
                        HTTP daemon; cli/ has export_serving, serve and
                        serve_client
  bench.py              the bench line (infer, train, reconstruct)
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "Predictor":
        from smirk_tpu_torch.api import Predictor

        return Predictor
    raise AttributeError(f"module 'smirk_tpu_torch' has no attribute {name!r}")
