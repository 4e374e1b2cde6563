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
    """``cuda`` when a card is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)
