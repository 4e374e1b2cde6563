"""Device and precision policy of the port.

Every tensor the port computes is float32. TF32 is switched off for both
matmuls and cuDNN here, once, so a float32 product on the card keeps its
full 24-bit mantissa (the JAX package pins HIGHEST matmul precision for
the same reason).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The device an entry point computes on when it is given none: the card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises where
    there is none: the port never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return default_device()
