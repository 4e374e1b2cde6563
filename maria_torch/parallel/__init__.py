"""Multi-card scaling over ``torch.distributed``
(maria_tpu/parallel/__init__.py).

The simulation's natural mesh is (det, time): detectors are independent
through atmosphere sampling, bandpass integration and noise synthesis;
the time axis is the sequence-like one. Map binning reduces over both.
The port runs one process a shard (a rank a card, as torchrun launches
them), and maria_tpu's collectives become:

- ``psum`` -> ``all_reduce`` over the mesh axes' process groups;
- the ``ppermute`` halo -> ``send``/``recv`` between neighbouring ranks;
- ``device_put`` with a sharding -> each rank holds only its rows
  (``shard_rows``, ``multihost.host_local_shard``).

``Mesh`` lays the ranks of the initialised default group out det-major
(rank = row-major index of its coordinates) and holds one process group
for every set of its axes. The backend is chosen by whoever starts the
world, and never switched here: "nccl" for ranks on cards of their own,
"gloo" for the CPU or for several ranks sharing one card (NCCL refuses
two ranks on one device). Under gloo a CUDA tensor goes to
``all_reduce`` as it is (gloo stages it through the host); ``send``,
``recv``, ``broadcast`` and ``all_gather`` copy it to the host here.

The draws of a sharded run are global: every rank consumes its
generator in the unsharded order, at each draw's global shape, and keeps
its rows (kernel K3 draws only its rows, through ``row0``), so a
sharded run's rows equal the unsharded run's for the same seed.

maria_tpu's fallback to forced CPU devices in ``create_mesh`` works
around a one-chip TPU runtime and has no counterpart: a mesh given no
device runs on the card (``LOCAL_RANK`` modulo the cards), and raises
where there is none.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "block_range", "create_mesh", "mesh_shape_for", "replicate", "shard_rows"]


def mesh_shape_for(n_devices: int) -> tuple:
    """A 2-D (det, time) mesh shape for n ranks: as square as possible,
    det-major (detectors usually outnumber useful time shards)."""
    d = int(np.floor(np.sqrt(n_devices)))
    while n_devices % d:
        d -= 1
    return (n_devices // d, d)


def block_range(n: int, size: int, index: int) -> tuple:
    """[start, stop) of block ``index`` of ``n`` items cut into ``size``
    blocks of ceil(n / size) (the last ones shorter or empty)."""
    block = -(-n // size)
    start = min(index * block, n)
    return start, min(start + block, n)


class Mesh:
    """The ranks of the default process group as a mesh of ``shape``
    with ``axis_names``: this rank's ``coords``, its ``device``, and one
    process group for every set of axes whose ranks number more than one."""

    def __init__(self, shape, axis_names, device):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised torch.distributed world "
                               "(multihost.initialize_multihost or torch.distributed.init_process_group)")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axes {self.axis_names} differ in length")
        self.size = int(np.prod(self.shape))
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"a mesh of shape {self.shape} needs {self.size} ranks; the world has {world}")
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an nccl world reduces CUDA tensors only, not {self.device.type} ones")
        # every rank creates every group, in the same order (new_group is
        # collective over the world); it keeps those it belongs to
        ranks = np.arange(self.size).reshape(self.shape)
        self._groups = {}
        for n_axes in range(1, len(self.shape) + 1):
            for axes in itertools.combinations(range(len(self.shape)), n_axes):
                members_size = int(np.prod([self.shape[a] for a in axes]))
                if members_size == 1:
                    continue
                if n_axes == len(self.shape):
                    self._groups[axes] = (dist.group.WORLD, list(range(self.size)))
                    continue
                rest = [a for a in range(len(self.shape)) if a not in axes]
                grid = np.transpose(ranks, rest + list(axes)).reshape(-1, members_size)
                for members in grid.tolist():
                    group = dist.new_group(members)
                    if self.rank in members:
                        self._groups[axes] = (group, members)

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, rank {self.rank} at {self.coords}, {self.device})"

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple of names; 1 for an axis
        the mesh lacks)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)] or [1]))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over several (0
        along axes the mesh lacks)."""
        idx = self._axes(axes)
        if not idx:
            return 0
        return int(np.ravel_multi_index([self.coords[a] for a in idx], [self.shape[a] for a in idx]))

    def block(self, n: int, axes="det") -> tuple:
        """[start, stop) of this rank's block of ``n`` items along ``axes``."""
        return block_range(n, self.axis_size(axes), self.axis_index(axes))

    def _axes(self, axes) -> tuple:
        if axes is None:
            return tuple(range(len(self.shape)))
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(sorted(self.axis_names.index(n) for n in names if n in self.axis_names))

    def group(self, axes=None):
        """(process group, its global ranks in axis order) over ``axes``
        (default all), or None when those axes hold one rank."""
        return self._groups.get(self._axes(axes))

    def _host_staged(self, x) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_reduce(self, x, axes=None):
        """Sum ``x`` over the ranks along ``axes`` (default all), in place;
        returns ``x``."""
        import torch.distributed as dist

        g = self.group(axes)
        if g is not None:
            dist.all_reduce(x, group=g[0])
        return x

    def all_gather(self, x, axes=None) -> list:
        """The ``x`` of every rank along ``axes`` (equal shapes), in axis order."""
        import torch.distributed as dist

        g = self.group(axes)
        if g is None:
            return [x]
        src = x.cpu() if self._host_staged(x) else x.contiguous()
        out = [torch.empty_like(src) for _ in g[1]]
        dist.all_gather(out, src, group=g[0])
        return [o.to(x.device) for o in out]

    def broadcast(self, x, axes=None):
        """``x`` of the first rank along ``axes``, on every rank of them, in
        place; returns ``x``."""
        import torch.distributed as dist

        g = self.group(axes)
        if g is None:
            return x
        buf = x.cpu() if self._host_staged(x) else x
        dist.broadcast(buf, src=g[1][0], group=g[0])
        if buf is not x:
            x.copy_(buf)
        return x

    def neighbour(self, axes, step: int):
        """Global rank ``step`` places along ``axes`` from this one, or None
        past either end."""
        g = self.group(axes)
        j = self.axis_index(axes) + step
        if g is None or not 0 <= j < len(g[1]):
            return None
        return g[1][j]

    def send(self, x, dst: int):
        import torch.distributed as dist

        dist.send(x.cpu() if self._host_staged(x) else x.contiguous(), dst)

    def recv(self, x, src: int):
        """Receive into ``x`` from global rank ``src``; returns ``x``."""
        import torch.distributed as dist

        buf = torch.empty_like(x, device="cpu") if self._host_staged(x) else x
        dist.recv(buf, src)
        if buf is not x:
            x.copy_(buf)
        return x

    def barrier(self):
        import torch.distributed as dist

        dist.barrier()


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device``, else the card ``LOCAL_RANK``
    (else the global rank) modulo the cards; raises without a card."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def create_mesh(n_devices: int = None, axis_names=("det", "time"), shape: tuple = None, device=None) -> Mesh:
    """A mesh over the initialised default group: ``shape`` (default
    ``mesh_shape_for(n_devices)``, or (n,) for one axis) with
    ``axis_names``, on this rank's ``device`` (default its card).
    ``n_devices`` defaults to the world size and must equal it."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised torch.distributed world: call "
                           "multihost.initialize_multihost() or torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = int(n_devices or world)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks on a world of {world}: one rank is one shard")
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else mesh_shape_for(n)
    return Mesh(shape, axis_names, rank_device(device))


def shard_rows(mesh: Mesh, x, axes="det"):
    """This rank's block of ``x``'s rows along ``axes``, on its device."""
    start, stop = mesh.block(x.shape[0], axes)
    return torch.as_tensor(x[start:stop]).to(mesh.device)


def replicate(mesh: Mesh, x):
    """``x`` on this rank's device, equal on every rank: rank 0's copy,
    broadcast."""
    return mesh.broadcast(torch.as_tensor(x).to(mesh.device).clone())
