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
  train/                SmirkSystem: infer and the two-path train_step
  api.py                Predictor
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "Predictor":
        from smirk_tpu_torch.api import Predictor

        return Predictor
    raise AttributeError(f"module 'smirk_tpu_torch' has no attribute {name!r}")
