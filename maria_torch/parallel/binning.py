"""Multi-card map binning (maria_tpu/parallel/binning.py).

A map over a sharded TOD is a segment-sum reduced across shards: every
(det, time) rank bins its LOCAL block with kernel K2 (``ops.bin_map``),
then one ``all_reduce`` over the mesh's det and time groups sums the
partial maps, so every rank holds the whole map.

maria_tpu's ``make_sharded_bin_plan`` and ``ShardedBinPlan`` exist to
give the TPU's one-hot MXU kernel equal static windows on every shard
(one compiled shard_map body); K2 scatters with atomics at any ids and
shape, so the port has no plans and no counterpart of them.
"""

from __future__ import annotations

from ..ops.bin_map import bin_map

__all__ = ["bin_sharded"]


def bin_sharded(channels, ids, n_pix: int, mesh, count: bool = False, axes=("det", "time")):
    """The map of a sharded TOD on every rank: K2 over this rank's block
    (``channels`` (C, n_local_det, n_local_t) or (n_local_det, n_local_t),
    ``ids`` its flat int32 pixel ids, -1 skipped; with ``count`` the hit
    count as one more channel), then the sum over the ranks along
    ``axes``. Returns (C [+ 1], n_pix) float32, the same on those ranks."""
    if channels.ndim == 2:
        channels = channels[None]
    return mesh.all_reduce(bin_map(channels.contiguous(), ids.contiguous(), n_pix, count=count), axes)
