"""Multi-process bring-up (maria_tpu/parallel/multihost.py).

One process a card, as torchrun starts them; the world is a
``torch.distributed`` process group, brought up opt-in:

    # on every node, with the same code and arguments:
    MARIA_TORCH_MULTIHOST=1 torchrun --nnodes N --nproc-per-node 8 \\
        --rdzv-endpoint HOST:PORT sim.py

    # inside sim.py:
    from maria_torch.parallel.multihost import initialize_multihost, create_multihost_mesh
    initialize_multihost()            # no-op unless MARIA_TORCH_MULTIHOST=1
    mesh = create_multihost_mesh()    # ("dcn", "det", "time")

Outside torchrun pass ``init_method`` ("tcp://host:port" or
"file:///path"), ``world_size`` and ``rank`` yourself. The backend is
"nccl" unless named: name "gloo" for CPU ranks, or for several ranks
that share one card (NCCL refuses two ranks on one device).

Axis layout: the outer "dcn" axis spans the nodes (torchrun numbers a
node's ranks consecutively), so the data collectives of the inner
(det, time) mesh stay within a node and only the final map reduction
crosses nodes. Per-node loading: ``process_detector_range`` gives a
rank its detector rows and ``host_local_shard`` calls a loader for that
block alone, so no rank builds the global array.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch

from . import Mesh, block_range, mesh_shape_for, rank_device

logger = logging.getLogger("maria_torch")

__all__ = [
    "create_multihost_mesh",
    "host_local_shard",
    "initialize_multihost",
    "is_multihost",
    "multihost_enabled",
    "process_detector_range",
]

ENV_FLAG = "MARIA_TORCH_MULTIHOST"


def multihost_enabled() -> bool:
    """Multi-process bring-up is opt-in: MARIA_TORCH_MULTIHOST=1 (so a
    single-process run, the test suite included, never waits on peers)."""
    return os.environ.get(ENV_FLAG, "").lower() in ("1", "true", "on")


def initialize_multihost(init_method: str = None, world_size: int = None, rank: int = None, backend: str = None,
                         timeout: timedelta = timedelta(minutes=10)) -> bool:
    """Bring up the default process group when multi-process mode is
    enabled (the flag, or an explicit ``init_method`` or ``world_size``).
    Returns True iff the world holds more than one rank after the call.
    Idempotent; a plain single-process run is a no-op, so every caller
    may invoke it. Without ``init_method`` the rendezvous is torchrun's
    environment ("env://": MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    ``backend`` defaults to "nccl"; it is never switched."""
    import torch.distributed as dist

    explicit = init_method is not None or world_size is not None
    if not (multihost_enabled() or explicit) or dist.is_initialized():
        return is_multihost()
    kwargs = {} if world_size is None else {"world_size": int(world_size)}
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(backend=backend or "nccl", init_method=init_method or "env://", timeout=timeout,
                            **kwargs)
    logger.info("multihost: rank %d/%d, backend %s", dist.get_rank(), dist.get_world_size(), dist.get_backend())
    return is_multihost()


def is_multihost() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def n_nodes() -> int:
    """Nodes of a torchrun world (WORLD_SIZE / LOCAL_WORLD_SIZE), else 1."""
    world, local = os.environ.get("WORLD_SIZE"), os.environ.get("LOCAL_WORLD_SIZE")
    if world and local and int(local) > 0:
        return max(int(world) // int(local), 1)
    return 1


def create_multihost_mesh(axis_names=("dcn", "det", "time"), dcn_size: int = None, det_time_shape: tuple = None,
                          device=None) -> Mesh:
    """A ("dcn", "det", "time") mesh of the world, the node-crossing axis
    outer. ``dcn_size`` defaults to the number of nodes (1 in a
    single-node world: the (det, time) layout with a size-1 outer axis);
    each node's ranks form the (det, time) grid of ``mesh_shape_for``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("create_multihost_mesh needs an initialised world (initialize_multihost)")
    n = dist.get_world_size()
    dcn = int(dcn_size or n_nodes())
    if n % dcn:
        raise ValueError(f"{n} ranks do not divide into {dcn} DCN groups.")
    per = n // dcn
    shape = tuple(det_time_shape or mesh_shape_for(per))
    if int(np.prod(shape)) != per:
        raise ValueError(f"det/time shape {shape} != {per} ranks a DCN group.")
    return Mesh((dcn, *shape), axis_names, rank_device(device))


def process_detector_range(n_det: int, mesh: Mesh, axis="det") -> tuple:
    """[start, stop) of the detector rows this rank holds on ``mesh``:
    its block along ``axis`` (a name, or a tuple such as ("dcn", "det")
    for rows split across nodes too). A rank builds pointing, tables and
    draws' rows only for this range."""
    return mesh.block(n_det, axis)


def host_local_shard(mesh: Mesh, global_shape: tuple, fill, spec=("det", "time")):
    """This rank's block of a global array of ``global_shape``, made by
    ``fill(index)``: ``index`` is a tuple of slices into the global array,
    dimension i cut along the mesh axes ``spec[i]`` (a name, a tuple of
    names, or None for whole), and ``fill`` is called once, for this
    rank's block alone. Returns the block as a tensor on the rank's device."""
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    index = tuple(slice(*block_range(int(n), mesh.axis_size(axes), mesh.axis_index(axes))) if axes else slice(0, int(n))
                  for n, axes in zip(global_shape, spec))
    block = fill(index)
    want = tuple(s.stop - s.start for s in index)
    out = block.to(mesh.device) if torch.is_tensor(block) else torch.as_tensor(np.asarray(block), device=mesh.device)
    if tuple(out.shape) != want:
        raise ValueError(f"fill returned a block of shape {tuple(out.shape)} for index {index}; expected {want}")
    return out
