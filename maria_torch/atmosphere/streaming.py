"""Streaming turbulence for arbitrarily long observations
(maria_tpu/atmosphere/streaming.py).

``StreamingExtrusion`` extrudes an AR screen in fixed chunks, carrying
the standing buffer (the ``n_extrusion`` rows every new row may
condition on) from chunk to chunk, so memory stays O(chunk) for any
duration. A chunk is one call of the AR kernel (``ops/ar_extrude.py``,
its plain loop on the CPU) for ``chunk_rows`` steps on a buffer of
``chunk_rows + n_extrusion`` rows; given the same innovations, the
chunks concatenate into the screen of one long extrusion.

``extrude_time_sharded`` lays the same stream over a mesh's time axis as
a pipeline, maria_tpu's halo ring: rank i receives rank i-1's standing
buffer (``recv``), extrudes its chunk with the AR kernel, and sends its
own buffer on (``send``); the chunks are all-gathered, so every rank
returns the whole stream, bit-equal to ``StreamingExtrusion``'s chunks
on the same innovations.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.ar_extrude import ar_extrude, ar_plan

__all__ = ["StreamingExtrusion", "extrude_time_sharded"]


class StreamingExtrusion:
    """Chunked AR extrusion of ``process`` with a carried standing buffer,
    on ``device`` (the card unless told otherwise)."""

    def __init__(self, process, chunk_rows: int, device=None):
        process.run_setup()
        self.process = process
        self.chunk_rows = int(chunk_rows)
        self.device = resolve_device(device)
        self._plans = {}

    def _plan(self, steps: int):
        if self.device.type != "cuda":
            return None
        if steps not in self._plans:
            self._plans[steps] = ar_plan([self.process], self.device, steps=[steps])
        return self._plans[steps]

    def initial_state(self, generator=None, buffer=None, noise=None):
        """The standing buffer (n_extrusion, n_cross): 2 n_extrusion rows
        extruded from a white buffer, the newest window kept, as the
        one-shot extrusion washes out its start. ``buffer`` ((3
        n_extrusion, n_cross)) and ``noise`` ((2 n_extrusion, n_cross))
        optionally supply the normals, else drawn from ``generator`` in
        that order."""
        p = self.process
        n_burn = 2 * p.n_extrusion
        f32 = dict(dtype=torch.float32, device=self.device)
        if buffer is None:
            buffer = torch.randn((n_burn + p.n_extrusion, p.n_cross_section), generator=generator, **f32)
        if noise is None:
            noise = torch.randn((n_burn, p.n_live_edge), generator=generator, **f32)
        buffer, noise = (x.to(**f32) if torch.is_tensor(x) else torch.tensor(x, **f32) for x in (buffer, noise))
        return ar_extrude([p], [buffer], [noise], plan=self._plan(n_burn), steps=[n_burn])[0]

    def step(self, state, noise):
        """(new state, chunk): ``chunk_rows`` new rows extruded from the
        carried ``state`` with the innovations ``noise`` ((chunk_rows,
        n_cross), read newest-row-first as one long extrusion reads them).
        The chunk's rows are in stream order (oldest first), so
        consecutive chunks concatenate into one continuous screen."""
        p, n = self.process, self.chunk_rows
        f32 = dict(dtype=torch.float32, device=self.device)
        full = torch.cat([torch.zeros((n, p.n_cross_section), **f32), torch.as_tensor(state, **f32)])
        out = ar_extrude([p], [full], [torch.as_tensor(noise, **f32)], plan=self._plan(n), steps=[n],
                         rows=max(n, p.n_extrusion))[0]
        return out[:p.n_extrusion], out[:n].flip(0)

    def run_chunks(self, n_chunks: int, generator=None) -> list:
        """``n_chunks`` consecutive screen chunks in stream order at
        O(chunk) memory, every draw from ``generator``: the start's, then
        each chunk's innovations."""
        state = self.initial_state(generator)
        chunks = []
        for _ in range(n_chunks):
            noise = torch.randn((self.chunk_rows, self.process.n_live_edge), generator=generator,
                                dtype=torch.float32, device=self.device)
            state, chunk = self.step(state, noise)
            chunks.append(chunk)
        return chunks


def extrude_time_sharded(process, key, chunk_rows: int, mesh, axis_name: str = "time", draws=None):
    """The stream of ``StreamingExtrusion(process, chunk_rows).run_chunks(n,
    generator)``, n the ranks along ``axis_name``, extruded a chunk a rank:
    (n * chunk_rows, n_cross) in stream order on every rank, on its device.

    ``key`` is a ``torch.Generator`` on the rank's device or an int seed
    of one; every rank consumes it as ``run_chunks`` does (the start's
    buffer and burn-in normals, then every chunk's innovations) and keeps
    its chunk's innovations. ``draws`` optionally supplies them instead:
    (buffer (3 n_extrusion, n_cross), burn-in (2 n_extrusion, n_live_edge),
    [n innovations (chunk_rows, n_live_edge)]). Rank 0 burns the standing
    buffer in; rank i > 0 receives it from rank i-1, and every rank but
    the last sends its own on after its chunk."""
    n_shards, index = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    stream = StreamingExtrusion(process, chunk_rows, device=mesh.device)
    p = process
    f32 = dict(dtype=torch.float32, device=mesh.device)
    if draws is None:
        gen = key
        if not isinstance(key, torch.Generator):
            gen = torch.Generator(device=mesh.device)
            gen.manual_seed(int(key))
        buffer = torch.randn((3 * p.n_extrusion, p.n_cross_section), generator=gen, **f32)
        burn = torch.randn((2 * p.n_extrusion, p.n_live_edge), generator=gen, **f32)
        noises = [torch.randn((stream.chunk_rows, p.n_live_edge), generator=gen, **f32) for _ in range(n_shards)]
    else:
        buffer, burn, noises = draws
        if len(noises) != n_shards:
            raise ValueError(f"{len(noises)} chunks of innovations for {n_shards} ranks along '{axis_name}'")
    if index == 0:
        state = stream.initial_state(buffer=buffer, noise=burn)
    else:
        state = mesh.recv(torch.empty((p.n_extrusion, p.n_cross_section), **f32), mesh.neighbour(axis_name, -1))
    state, chunk = stream.step(state, noises[index])
    downstream = mesh.neighbour(axis_name, 1)
    if downstream is not None:
        mesh.send(state.contiguous(), downstream)
    return torch.cat(mesh.all_gather(chunk.contiguous(), axis_name))
