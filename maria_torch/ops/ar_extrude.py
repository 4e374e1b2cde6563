"""The autoregressive extrusion loop: the CUDA kernel ``csrc/ar_extrude.cu``
and its plain torch version.

``ar_extrude_reference(A, B, buffer, ext_idx, cross_idx, noise)`` is
maria_tpu's ``_ar_extrude_noise`` (a ``lax.scan``) as a Python loop: it
fills rows ``n_steps - 1`` down to 0 of a copy of ``buffer``, row b from
rows ``b + ext_idx + 1`` at columns ``cross_idx`` and the innovations
``noise``, read newest-row-first. On the card it is five or so launches a
step, so ``ar_extrude(processes, buffers, noises)`` runs all of a
realization's processes in one launch of the kernel, a block each. The
initial buffers and the innovations are the caller's (drawn from its
``torch.Generator``), so the kernel and the plain loop compute the same
numbers; on CPU tensors ``ar_extrude`` runs the plain loop.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

__all__ = ["ar_extrude", "ar_extrude_reference", "ar_plan", "ar_smem_bytes", "probe_latencies"]

DESC_INTS = 10  # ints a process takes in the kernel's descriptor table
MAX_THREADS = 1024


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


def ar_smem_bytes(n_cross: int, n_sample: int, staged: bool) -> int:
    """Shared memory one block of the kernel takes: the samples, the
    innovations and the gather offsets, and with ``staged`` A and B."""
    words = 2 * _pad4(n_sample) + _pad4(n_cross)
    if staged:
        words += n_cross * n_sample + n_cross * n_cross
    return 4 * words


def ar_plan(processes, device) -> dict:
    """The kernel's static inputs for ``processes`` on the card
    ``device``: the flat A, B and gather offsets, the descriptor table,
    the block size, the shared memory and the element offsets of each
    process's buffer and innovations."""
    device = torch.device(device)
    lib = kernels.load()
    smem_limit = lib.maria_max_dynamic_smem(device.index if device.index is not None else torch.cuda.current_device())
    if smem_limit <= 0:
        raise RuntimeError("could not read the card's shared memory limit")
    tabs = [p.tensors(device) for p in processes]
    desc, goffs = [], []
    a_off = b_off = g_off = buf_off = noise_off = 0
    buf_offsets, smem = [], 0
    for p in processes:
        n_cross, n_sample = p.n_cross_section, p.n_sample
        staged = ar_smem_bytes(n_cross, n_sample, True) <= smem_limit
        smem = max(smem, ar_smem_bytes(n_cross, n_sample, staged))
        desc.append([a_off, b_off, g_off, buf_off, noise_off, n_cross, n_sample, p.n_steps, int(staged), 0])
        goffs.append((np.asarray(p.extrusion_sample_index) + 1) * n_cross + np.asarray(p.cross_section_sample_index))
        buf_offsets.append(buf_off)
        a_off += n_cross * n_sample
        b_off += n_cross * n_cross
        g_off += n_sample
        buf_off += p.n_buffer * n_cross
        noise_off += p.n_steps * n_cross
    if max(a_off, buf_off, noise_off) >= 2**31:
        raise ValueError("the processes' arrays exceed the kernel's 32-bit offsets")
    i32 = dict(dtype=torch.int32, device=device)
    warps = min(MAX_THREADS // 32, max(p.n_cross_section for p in processes))
    return {
        "A": torch.cat([t["A"].reshape(-1) for t in tabs]),
        "B": torch.cat([t["B"].reshape(-1) for t in tabs]),
        "goff": torch.as_tensor(np.concatenate(goffs).astype(np.int32), **i32),
        "desc": torch.as_tensor(np.asarray(desc, dtype=np.int32).reshape(-1), **i32),
        "staged": [bool(d[8]) for d in desc],
        "threads": 32 * warps,
        "smem": smem,
        "buf_offsets": buf_offsets,
        "n_buffer": buf_off,
        "n_noise": noise_off,
    }


def _check(processes, buffers, noises):
    if not (len(processes) == len(buffers) == len(noises)) or not processes:
        raise ValueError("ar_extrude takes one buffer and one noise array per process, and at least one process")
    device = buffers[0].device
    for p, buf, eps in zip(processes, buffers, noises):
        if tuple(buf.shape) != (p.n_buffer, p.n_cross_section) or tuple(eps.shape) != (p.n_steps, p.n_cross_section):
            raise ValueError(
                f"a process of {p.n_extrusion} x {p.n_cross_section} takes a ({p.n_buffer}, {p.n_cross_section}) "
                f"buffer and ({p.n_steps}, {p.n_cross_section}) noise, got {tuple(buf.shape)} and {tuple(eps.shape)}"
            )
        if buf.dtype != torch.float32 or eps.dtype != torch.float32:
            raise ValueError(f"buffer and noise must be float32, got {buf.dtype} and {eps.dtype}")
        if buf.device != device or eps.device != device:
            raise ValueError("every buffer and noise array must lie on one device")
    return device


def ar_extrude(processes, buffers, noises, plan=None) -> list:
    """Each process's (n_extrusion, n_cross) float32 screen: the first
    n_extrusion rows of its extruded buffer. ``buffers`` and ``noises``
    give each process's (n_buffer, n_cross) initial buffer and
    (n_steps, n_cross) innovations (``AutoregressiveProcess.draw``), all
    on one device; they are not changed. On a CUDA device one kernel
    launch runs every process (``plan``: ``ar_plan`` of the processes on
    that device, built here when not given)."""
    device = _check(processes, buffers, noises)
    if device.type == "cpu":
        out = []
        for p, buf, eps in zip(processes, buffers, noises):
            t = p.tensors(device)
            out.append(ar_extrude_reference(t["A"], t["B"], buf, t["ext_idx"], t["cross_idx"], eps)[: p.n_extrusion])
        return out
    if device.type != "cuda":
        raise ValueError(f"ar_extrude runs on cpu or cuda tensors, not {device.type}")
    if plan is None:
        plan = ar_plan(processes, device)
    buffer = torch.cat([b.reshape(-1) for b in buffers])
    noise = torch.cat([e.reshape(-1) for e in noises])
    lib = kernels.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.maria_ar_extrude(
        plan["desc"].data_ptr(), len(processes), plan["A"].data_ptr(), plan["B"].data_ptr(), plan["goff"].data_ptr(),
        buffer.data_ptr(), noise.data_ptr(), plan["threads"], plan["smem"], stream,
    )
    kernels.check(lib, code, "ar_extrude kernel launch")
    ar_extrude.launches += 1
    return [buffer[off: off + p.n_extrusion * p.n_cross_section].view(p.n_extrusion, p.n_cross_section)
            for p, off in zip(processes, plan["buf_offsets"])]


ar_extrude.launches = 0


# block size of the barrier probe: one warp, the smallest block that can
# hold a step's dot, so the bound does not grow with the kernel's own block
PROBE_THREADS = 32


def probe_latencies(device, iters: int = 1 << 20) -> dict:
    """{"fma_ns", "barrier_ns"}: the card's latency of one dependent FMA
    (a chain in one warp) and of one block barrier in a block of
    PROBE_THREADS, by CUDA events over ``iters`` of each. For the
    kernel's latency bound (chip_smoke.py); not a part of the extrusion."""
    lib = kernels.load()
    out = torch.zeros(32, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {}
    for name, mode in (("fma_ns", 0), ("barrier_ns", 1)):
        kernels.check(lib, lib.maria_ar_probe(mode, 1024, PROBE_THREADS, out.data_ptr(), stream), "ar probe launch")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.check(lib, lib.maria_ar_probe(mode, iters, PROBE_THREADS, out.data_ptr(), stream), "ar probe launch")
        end.record()
        torch.cuda.synchronize(device)
        result[name] = start.elapsed_time(end) * 1e6 / iters
    return result
