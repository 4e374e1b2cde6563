"""Work item: the noise's one matrix product (``noise/dft.py``), total =
A + row_scale * (V @ B), V (m, k) and B (k, n) in bfloat16, accumulated
and written in float32: 2 m k n operations; V and B read once and the
(m, n) float32 product written once."""

import re

from .. import peaks

PATTERN = re.compile(r"(?i)^(?=.*(gemm|nvjet|cutlass|xmma))(?=.*bf16)")


def matches(name: str) -> bool:
    return bool(PATTERN.search(name))


def cost(m: int, k: int, n: int, **_) -> dict:
    return {"flops": 2.0 * m * k * n, "bytes": 2.0 * (m * k + k * n) + 4.0 * m * n}


def least_seconds(shape: dict) -> float:
    c = cost(**shape)
    return max(c["flops"] / peaks.BF16_FLOPS, c["bytes"] / peaks.HBM_BYTES_PER_S)
