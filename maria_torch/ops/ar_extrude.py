"""The autoregressive extrusion loop: the CUDA kernel ``csrc/ar_extrude.cu``
and its plain torch version.

``ar_extrude_reference(A, B, buffer, ext_idx, cross_idx, noise)`` is
maria_tpu's ``_ar_extrude_noise`` (a ``lax.scan``) as a Python loop: it
fills rows ``n_steps - 1`` down to 0 of a copy of ``buffer``, row b from
rows ``b + ext_idx + 1`` at columns ``cross_idx`` and the innovations
``noise``, read newest-row-first. On the card it is five or so launches a
step, so ``ar_extrude(processes, buffers, noises)`` runs all of a
realization's processes in one launch of the kernel. The initial buffers
and the innovations are the caller's (drawn from its ``torch.Generator``),
so the kernel and the plain loop compute the same numbers; on CPU tensors
``ar_extrude`` runs the plain loop.

How the kernel is laid out (``ar_plan``; the source note of
``csrc/ar_extrude.cu`` says why). A process runs on a thread-block
cluster of C blocks, one where the process fits a block's shared memory
and eight otherwise: block c keeps rows ``c rows`` to
``(c + 1) rows`` of A and B there for the whole launch, and two copies of
the step's lookback samples and innovations (this step's and the
next's). Only the lookback samples with ``ext_idx == 0`` depend on the
step before, so every other sample of step i + 1 and its innovations are
loaded from device memory during step i, and a finished row goes straight
into the ``ext_idx == 0`` slots of the next vector of every block of the
cluster (``ar_tables``: which slots take which column). A step is then
one dot a row out of shared memory and one barrier: of the block when C
is 1 (every 2-D process of the scenes), of the cluster otherwise (the
AtLAST-50k 3-D process). A process too large for C = 8 runs in one block
and reads A and B through L2. One launch has one cluster size, so a
call's processes are grouped by it: one launch a group, one group a
scene.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

__all__ = ["ar_cluster_size", "ar_extrude", "ar_extrude_reference", "ar_plan", "ar_smem_bytes", "ar_tables",
           "probe_latencies"]

DESC_INTS = 10  # ints a process takes in the kernel's descriptor table
MAX_THREADS = 1024  # the largest block of a launch on clusters
ONE_BLOCK_THREADS = 512  # and of one with a block a process, built for half the card's block (csrc/ar_extrude.cu)
# The cluster sizes the plan chooses from, in order of preference: one
# block where a process fits it, otherwise eight, the largest cluster every
# card of the architecture schedules. The kernel runs on 2 and 4 blocks as
# well (any power of two), but where a process needs a cluster at all, the
# largest is the fastest. The AtLAST-50k 3-D process (252 x 510) on an NVIDIA
# H100 80GB HBM3 at 700 W (python -m maria_torch.profile_ar): 1.26 ms on four
# blocks of 63 rows, 0.78 ms on eight of 32 (6.0-8.4 ms through L2 from one);
# a cluster's barrier costs the same at four and eight blocks of 1,024
# threads (0.69 and 0.71 us), and a block's share of A and B halves.
CLUSTER_SIZES = (1, 8)


def ar_extrude_reference(A, B, buffer, ext_idx, cross_idx, noise):
    """(n_steps + n_lookback, n_cross): ``buffer`` with rows n_steps - 1
    down to 0 filled; ``buffer`` itself is not changed."""
    buffer = buffer.clone()
    n_steps = noise.shape[0]
    for i in range(n_steps):
        b = n_steps - 1 - i
        buffer[b] = A @ buffer[b + ext_idx + 1, cross_idx] + B @ noise[i]
    return buffer


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _pad32(n: int) -> int:
    return (n + 31) & ~31


def ar_tables(ext_idx, cross_idx, n_cross: int) -> dict:
    """The kernel's index tables of one process, from its lookback
    indices (any, not only the ones ``AutoregressiveProcess`` derives):

    - ``goff`` (n_sample): sample s of the step that fills row b is
      ``buffer[b n_cross + goff[s]]``;
    - ``old`` (n_old): the samples with ``ext_idx >= 1``, which lie in rows
      finished at least two steps before and are loaded a step ahead;
    - ``new_start`` (n_cross + 1), ``new_slot``: the samples with
      ``ext_idx == 0`` by column: the row a step writes goes, column r,
      into the next step's slots ``new_slot[new_start[r]:new_start[r + 1]]``
      (none, one or several).
    """
    ext_idx, cross_idx = np.asarray(ext_idx, dtype=np.int64), np.asarray(cross_idx, dtype=np.int64)
    if ext_idx.shape != cross_idx.shape or ext_idx.ndim != 1:
        raise ValueError("the lookback indices must be two 1-D arrays of one length")
    if ext_idx.min() < 0 or cross_idx.min() < 0 or cross_idx.max() >= n_cross:
        raise ValueError("a lookback index lies outside the buffer")
    newest = np.flatnonzero(ext_idx == 0)
    order = np.argsort(cross_idx[newest], kind="stable")
    return {
        "goff": ((ext_idx + 1) * n_cross + cross_idx).astype(np.int32),
        "old": np.flatnonzero(ext_idx > 0).astype(np.int32),
        "new_start": np.searchsorted(cross_idx[newest][order], np.arange(n_cross + 1)).astype(np.int32),
        "new_slot": newest[order].astype(np.int32),
    }


def ar_smem_bytes(n_cross: int, n_sample: int, cluster: int) -> int:
    """Shared memory one block of the kernel takes for a process run by
    ``cluster`` blocks: two sample-and-innovation vectors, the slots its
    rows go to and its rows of A and B; with ``cluster`` 0 (A and B read
    through L2) everything but those rows."""
    rows = -(-n_cross // max(cluster, 1))
    n_vec = _pad32(n_sample) + _pad32(n_cross)  # samples and innovations, each padded to whole warps
    words = 2 * n_vec + _pad4(rows + 1) + _pad4(n_sample)
    if cluster:
        words += rows * n_vec
    return 4 * words


def ar_cluster_size(n_cross: int, n_sample: int, smem_limit: int, sizes=CLUSTER_SIZES) -> int:
    """Blocks that run one process: the first of ``sizes`` whose share of
    A and B fits ``smem_limit`` bytes of shared memory a block; 0 when
    none does (one block, A and B through L2)."""
    for cluster in sizes:
        if ar_smem_bytes(n_cross, n_sample, cluster) <= smem_limit:
            return cluster
    return 0


def ar_plan(processes, device, smem_limit: int = None, sizes=CLUSTER_SIZES, steps=None) -> dict:
    """The kernel's static inputs for ``processes`` on ``device``:
    ``cluster`` (each process's cluster size, 0 for the through-L2 form)
    and ``groups``, one launch each: the processes of one cluster size
    (``index``), their flat A, B and index tables, the descriptor table,
    the block size, the shared memory and rows a block, and the element
    offsets of each process's buffer. ``smem_limit`` is the shared memory
    a block may take, by default what the card allows; ``sizes`` as in
    ``ar_cluster_size``. ``steps`` gives each process's step count, by
    default its ``n_steps`` (a chunk of a streamed extrusion takes fewer
    or more, on a buffer of steps + n_extrusion rows)."""
    device = torch.device(device)
    steps = [p.n_steps for p in processes] if steps is None else [int(s) for s in steps]
    if smem_limit is None:
        lib = kernels.load()
        smem_limit = lib.maria_max_dynamic_smem(
            device.index if device.index is not None else torch.cuda.current_device())
        if smem_limit <= 0:
            raise RuntimeError("could not read the card's shared memory limit")
    clusters = [ar_cluster_size(p.n_cross_section, p.n_sample, smem_limit, sizes) for p in processes]
    groups = []
    for size in sorted({max(c, 1) for c in clusters}):
        index = [k for k, c in enumerate(clusters) if max(c, 1) == size]
        desc, tables, buf_offsets, rows = [], [], [], []
        a_off = b_off = tab_off = buf_off = noise_off = smem = 0
        for k in index:
            p = processes[k]
            n_cross, n_sample = p.n_cross_section, p.n_sample
            tab = ar_tables(p.extrusion_sample_index, p.cross_section_sample_index, n_cross)
            if int(tab["goff"].max()) >= (p.n_extrusion + 1) * n_cross:
                raise ValueError("a lookback index lies outside the buffer")
            smem = max(smem, ar_smem_bytes(n_cross, n_sample, clusters[k]))
            rows.append(-(-n_cross // size))
            desc.append([a_off, b_off, tab_off, buf_off, noise_off, n_cross, n_sample, steps[k],
                         int(clusters[k] > 0), len(tab["old"])])
            tables += [tab["goff"], tab["old"], tab["new_start"], tab["new_slot"]]
            buf_offsets.append(buf_off)
            a_off += n_cross * n_sample
            b_off += n_cross * n_cross
            tab_off += 2 * n_sample + n_cross + 1
            buf_off += (p.n_extrusion + steps[k]) * n_cross
            noise_off += steps[k] * n_cross
        if max(a_off, buf_off, noise_off) >= 2**31:
            raise ValueError("the processes' arrays exceed the kernel's 32-bit offsets")
        if smem > smem_limit:
            raise ValueError(f"a process needs {smem} bytes of shared memory a block, over the limit of {smem_limit}")
        tabs = [processes[k].tensors(device) for k in index]
        i32 = dict(dtype=torch.int32, device=device)
        groups.append({
            "cluster": size,
            "index": index,
            "A": torch.cat([t["A"].reshape(-1) for t in tabs]),
            "B": torch.cat([t["B"].reshape(-1) for t in tabs]),
            "tab": torch.as_tensor(np.concatenate(tables), **i32),
            "desc": torch.as_tensor(np.asarray(desc, dtype=np.int32).reshape(-1), **i32),
            "threads": 32 * min((MAX_THREADS if size > 1 else ONE_BLOCK_THREADS) // 32, max(rows)),
            "smem": smem,
            "rows": rows,
            "buf_offsets": buf_offsets,
        })
    return {"cluster": clusters, "groups": groups, "steps": steps}


def _check(processes, buffers, noises, steps):
    if not (len(processes) == len(buffers) == len(noises) == len(steps)) or not processes:
        raise ValueError("ar_extrude takes one buffer and one noise array per process, and at least one process")
    device = buffers[0].device
    for p, buf, eps, n in zip(processes, buffers, noises, steps):
        n_buffer = p.n_extrusion + n
        if n < 1 or tuple(buf.shape) != (n_buffer, p.n_cross_section) or tuple(eps.shape) != (n, p.n_cross_section):
            raise ValueError(
                f"a process of {p.n_extrusion} x {p.n_cross_section} run for {n} steps takes a ({n_buffer}, "
                f"{p.n_cross_section}) buffer and ({n}, {p.n_cross_section}) noise, got {tuple(buf.shape)} and "
                f"{tuple(eps.shape)}"
            )
        if buf.dtype != torch.float32 or eps.dtype != torch.float32:
            raise ValueError(f"buffer and noise must be float32, got {buf.dtype} and {eps.dtype}")
        if buf.device != device or eps.device != device:
            raise ValueError("every buffer and noise array must lie on one device")
    return device


def ar_extrude(processes, buffers, noises, plan=None, steps=None, rows=None) -> list:
    """Each process's (n_extrusion, n_cross) float32 screen: the first
    n_extrusion rows of its extruded buffer. ``buffers`` and ``noises``
    give each process's (n_buffer, n_cross) initial buffer and
    (n_steps, n_cross) innovations (``AutoregressiveProcess.draw``), all
    on one device; they are not changed. On a CUDA device one kernel
    launch runs every process of one cluster size (``plan``: ``ar_plan``
    of the processes on that device, built here when not given).

    A streamed extrusion (``atmosphere/streaming.py``) runs a chunk:
    ``steps`` gives each process's step count (buffers of steps +
    n_extrusion rows, noise of steps rows; ``plan`` built with the same
    ``steps``), and ``rows`` how many of the extruded buffer's first rows
    come back (default n_extrusion). Without them a call is as before."""
    steps = [p.n_steps for p in processes] if steps is None else [int(s) for s in steps]
    device = _check(processes, buffers, noises, steps)
    if device.type == "cpu":
        out = []
        for p, buf, eps in zip(processes, buffers, noises):
            t = p.tensors(device)
            n_rows = p.n_extrusion if rows is None else rows
            out.append(ar_extrude_reference(t["A"], t["B"], buf, t["ext_idx"], t["cross_idx"], eps)[:n_rows])
        return out
    if device.type != "cuda":
        raise ValueError(f"ar_extrude runs on cpu or cuda tensors, not {device.type}")
    if plan is None:
        plan = ar_plan(processes, device, steps=steps)
    elif plan.get("steps", [p.n_steps for p in processes]) != steps:
        raise ValueError(f"the plan was made for {plan.get('steps')} steps, the call runs {steps}")
    lib = kernels.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = [None] * len(processes)
    for g in plan["groups"]:
        buffer = torch.cat([buffers[k].reshape(-1) for k in g["index"]])
        noise = torch.cat([noises[k].reshape(-1) for k in g["index"]])
        code = lib.maria_ar_extrude(
            g["desc"].data_ptr(), len(g["index"]), g["A"].data_ptr(), g["B"].data_ptr(), g["tab"].data_ptr(),
            buffer.data_ptr(), noise.data_ptr(), g["threads"], g["smem"], g["cluster"], stream,
        )
        kernels.check(lib, code, f"ar_extrude kernel launch (clusters of {g['cluster']})")
        ar_extrude.launches += 1
        for k, off in zip(g["index"], g["buf_offsets"]):
            p = processes[k]
            n_rows = p.n_extrusion if rows is None else rows
            out[k] = buffer[off: off + n_rows * p.n_cross_section].view(n_rows, p.n_cross_section)
    return out


ar_extrude.launches = 0


# block size of the barrier probe: one warp, the smallest block that can
# hold a step's dot, so the bound does not grow with the kernel's own block
PROBE_THREADS = 32


def _probe_ns(lib, device, mode: int, iters: int, threads: int, cluster: int) -> float:
    out = torch.zeros(32, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels.check(lib, lib.maria_ar_probe(mode, 1024, threads, cluster, out.data_ptr(), stream), "ar probe launch")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kernels.check(lib, lib.maria_ar_probe(mode, iters, threads, cluster, out.data_ptr(), stream), "ar probe launch")
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e6 / iters


def probe_latencies(device, iters: int = 1 << 20, cluster: int = 1, threads: int = PROBE_THREADS) -> dict:
    """{"fma_ns", "barrier_ns", "step_barrier_ns"}: the card's latency of
    one dependent FMA (a chain in one warp) and of one block barrier in a
    block of PROBE_THREADS, by CUDA events over ``iters`` of each: the
    kernel's latency bound (chip_smoke.py) takes these two. The third is
    the barrier a step of the kernel really pays, for reading the gap to
    that bound: a block barrier of ``threads`` threads, or with
    ``cluster`` > 1 one barrier of a cluster of that many such blocks. Not
    a part of the extrusion."""
    lib = kernels.load()
    return {
        "fma_ns": _probe_ns(lib, device, 0, iters, PROBE_THREADS, 1),
        "barrier_ns": _probe_ns(lib, device, 1, iters, PROBE_THREADS, 1),
        "step_barrier_ns": _probe_ns(lib, device, 2 if cluster > 1 else 1, iters >> 3, threads, cluster),
    }
