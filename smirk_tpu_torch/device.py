"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller passes `device="cpu"`
(as the tests do). Without a card and without an explicit CPU request they
raise: nothing falls back to the CPU behind the caller's back.

`fp32_math` pins the precision of an entry point: exact fp32, whatever the
process's global TF32 flags say (torch allows TF32 in cuDNN convolutions
by default).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


_pin_lock = threading.Lock()
_pin_depth = 0
_pin_saved = (True, True)


@contextlib.contextmanager
def fp32_math():
    """Within the block cuDNN convolutions and CUDA matmuls run in exact
    fp32 (both legacy TF32 flags False; the JAX package's
    `bf16_compute=False`); when the last block open in the process exits,
    also by a raise, both flags read what they read before the first one
    entered. The count is kept under a lock, so blocks that nest or
    overlap across threads never restore the flags while another is still
    inside. Usable as a decorator."""
    global _pin_depth, _pin_saved
    backends = torch.backends
    with _pin_lock:
        if _pin_depth == 0:
            _pin_saved = backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32
        _pin_depth += 1
        backends.cudnn.allow_tf32 = False
        backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _pin_lock:
            _pin_depth -= 1
            if _pin_depth == 0:
                backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = _pin_saved
