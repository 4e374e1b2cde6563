"""Work item: kernel K2 (``ops/bin_map.py``, ``csrc/bin_map.cu``), the
binning of a TOD of ``values`` float32 samples at int32 pixel ids into
``maps`` maps of n_pix float32 values (a hit count among them), with
``weights`` float32 weights a detector where the binning weighs them.
Its least work, whatever layout a kernel reads: the TOD and the ids read
once, the weights read once, each map written once. Memory-bound: no
operation count bounds it."""

import re

from .. import peaks

PATTERN = re.compile(r"bin_map_kernel")


def matches(name: str) -> bool:
    return bool(PATTERN.search(name))


def cost(values: int, n_pix: int, maps: int, weights: int = 0, **_) -> dict:
    return {"flops": float(values * maps), "bytes": 4.0 * (2 * values + weights + n_pix * maps)}


def least_seconds(shape: dict) -> float:
    return cost(**shape)["bytes"] / peaks.HBM_BYTES_PER_S
