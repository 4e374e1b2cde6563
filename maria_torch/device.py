"""Device and precision policy of the port.

Every tensor the port computes is float32. TF32 is switched off for both
matmuls and cuDNN here, once, so a float32 product on the card keeps its
full 24-bit mantissa (the JAX package pins HIGHEST matmul precision for
the same reason).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The device an entry point computes on when it is given none: the card."""
    return torch.device("cuda")


def check_float32(dtype):
    """The port computes in float32 only: a ``dtype=`` keyword of any
    other type (torch or numpy) raises."""
    ok = dtype is torch.float32
    if not ok:
        try:
            ok = np.dtype(dtype) == np.float32
        except TypeError:
            ok = False
    if not ok:
        raise ValueError(f"dtype {dtype!r}: the port computes in float32 only")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises where
    there is none: the port never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return default_device()


def as_float32_tensors(*xs, device=None) -> list:
    """The arguments as float32 tensors on one device: that of the first
    tensor among them, else ``device`` (the card when None, as
    ``resolve_device``). The port's device functions take their inputs
    through it, so array-likes alone compute on the card."""
    on = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    on = resolve_device(device) if on is None else on
    return [x.to(device=on, dtype=torch.float32) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x, dtype=np.float32), device=on) for x in xs]
