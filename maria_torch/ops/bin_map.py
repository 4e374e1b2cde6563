"""Map binning: kernel K2 and its plain torch version.

``bin_map(channels, pixel_ids, n_pix)`` sums each channel of
(C, n_det, n_t) float32 data into a (C, n_pix) map at the flat pixel ids
(n_det, n_t) int32; ids outside [0, n_pix) (-1 marks off-map samples)
are skipped. With ``count=True`` it returns (C + 1, n_pix), whose last row
is the number of in-range samples a pixel (exact in float32 below 2^24),
counted with no channel of ones. On a CUDA tensor it launches
``csrc/bin_map.cu`` (which replaces maria_tpu's ``bin_blocked_pallas``) as
``bin_plan`` lays it out; on a CPU tensor it runs the plain version,
``index_add_`` and ``bincount``. The kernel sums with atomics, so the
order of the additions, and the last bits of a sum, vary from run to run.
"""

from __future__ import annotations

import math
from functools import lru_cache
from types import MappingProxyType

import torch

from . import kernels

__all__ = ["bin_map", "bin_map_plain", "bin_plan", "launch"]

SMEM_MAX = 232_448  # dynamic shared memory a block may use on an H100
MAX_SLOTS = 4  # slots (channels, or the count) a block bins (kMaxSlots in csrc/bin_map.cu)
STEP = 128  # samples a warp loads at once (32 lanes x kUnroll): a block's range is a multiple
THREADS_SHARED = 1024  # a privatised block: one an SM, since its map takes most of the SM's shared memory
THREADS_GLOBAL = 256
GLOBAL_BLOCKS_PER_SM = 8
# A privatised block zeroes and flushes its slots' maps, so it gets at
# least this many samples a pixel of its map (PERF.md: the sweep of
# python -m maria_torch.profile_bin)
SAMPLES_PER_PIXEL = 1
N_SM = 132  # an H100 SXM's streaming multiprocessors


@lru_cache(maxsize=256)
def bin_plan(n_pix: int, n_channels: int, n_samples: int, count: bool = False, n_sm: int = N_SM,
             samples_per_pixel: float = SAMPLES_PER_PIXEL) -> dict:
    """How K2 bins ``n_samples`` samples of ``n_channels`` channels (and
    the count) into ``n_pix`` pixels. Slots are the channels, then the
    count. Forms:
      private: every slot's map fits one block's shared memory;
      split: up to MAX_SLOTS slots a block, over ``groups`` = gridDim.y;
      global: one slot's map does not fit; atomics go to the output.
    K2 launches the groups - 1 full groups together, then the last group;
    each launch gets the blocks for the groups it holds. Returns form,
    slots, per (slots a block), groups, threads and smem (bytes a block);
    blocks (gridDim.x) and span (samples a block, a multiple of STEP) of
    the last group's launch; full_blocks and full_span of the full
    groups' launch (0 when there is one group); as a read-only mapping
    (plans are cached)."""
    slots = n_channels + int(bool(count))
    if slots < 1 or n_pix < 1:
        raise ValueError(f"bin_plan needs a slot and a pixel, got {n_channels} channels, count {count}, {n_pix} pixels")
    fit = SMEM_MAX // (4 * n_pix)  # slots whose maps fit one block
    per = min(MAX_SLOTS, slots, fit if fit >= 1 else MAX_SLOTS)
    groups = -(-slots // per)
    if fit >= 1:
        form = "private" if groups == 1 else "split"
        threads, smem = THREADS_SHARED, 4 * per * n_pix
    else:
        form, threads, smem = "global", THREADS_GLOBAL, 0

    def sized(n_groups: int) -> tuple:
        """(blocks, span) of a launch of n_groups groups of blocks."""
        if fit >= 1:
            blocks = min(math.ceil(n_samples / (samples_per_pixel * n_pix)), max(1, n_sm // n_groups))
        else:
            blocks = min(-(-n_samples // (32 * threads)), max(1, n_sm * GLOBAL_BLOCKS_PER_SM // n_groups))
        span = max(STEP, -(-n_samples // (max(1, blocks) * STEP)) * STEP)
        return max(1, -(-n_samples // span)), span

    blocks, span = sized(1)
    full_blocks, full_span = sized(groups - 1) if groups > 1 else (0, 0)
    return MappingProxyType({"form": form, "slots": slots, "per": per, "groups": groups, "threads": threads,
                             "smem": smem, "blocks": blocks, "span": span, "full_blocks": full_blocks,
                             "full_span": full_span})


def _check(channels, pixel_ids):
    if channels.ndim != 3 or channels.dtype != torch.float32:
        raise ValueError(f"channels must be float32 (C, n_det, n_t), got {channels.dtype} {tuple(channels.shape)}")
    if pixel_ids.dtype != torch.int32 or tuple(pixel_ids.shape) != tuple(channels.shape[1:]):
        raise ValueError(
            f"pixel_ids must be int32 {tuple(channels.shape[1:])}, got {pixel_ids.dtype} {tuple(pixel_ids.shape)}"
        )
    if channels.device != pixel_ids.device:
        raise ValueError("channels and pixel_ids must be on the same device")


def bin_map_plain(channels, pixel_ids, n_pix: int, count: bool = False):
    """Plain torch version: index_add_ along the flat pixel axis, and
    bincount for the count row."""
    _check(channels, pixel_ids)
    ids = pixel_ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < n_pix)
    n_channels = channels.shape[0]
    data = channels.reshape(n_channels, -1)[:, keep]
    out = torch.zeros((n_channels + int(count), n_pix), dtype=torch.float32, device=channels.device)
    out[:n_channels].index_add_(1, ids[keep], data)
    if count:
        out[n_channels] = torch.bincount(ids[keep], minlength=n_pix).to(torch.float32)
    return out


@lru_cache(maxsize=8)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(plan: dict, channels, pixel_ids, n_pix: int):
    """Run K2 as ``plan`` lays it out (``bin_plan`` of these shapes, or
    another, as profile_bin sweeps). Returns (plan["slots"], n_pix)."""
    n_channels = channels.shape[0]
    n_samples = pixel_ids.numel()
    if n_samples == 0:
        return torch.zeros((plan["slots"], n_pix), dtype=torch.float32, device=channels.device)
    out = torch.empty((plan["slots"], n_pix), dtype=torch.float32, device=channels.device)  # zeroed by the launch
    lib = kernels.load()
    stream = torch.cuda.current_stream(channels.device).cuda_stream
    code = lib.maria_bin_map(
        channels.data_ptr(), pixel_ids.data_ptr(), out.data_ptr(), n_samples, n_channels, plan["slots"], int(n_pix),
        plan["per"], plan["groups"], plan["threads"], int(plan["form"] != "global"), plan["full_blocks"],
        plan["full_span"], plan["blocks"], plan["span"], stream,
    )
    kernels.check(lib, code, "bin_map kernel launch")
    bin_map.launches += 1
    return out


def bin_map(channels, pixel_ids, n_pix: int, count: bool = False):
    """(C, n_pix) float32 sums of each channel at each pixel; with
    ``count``, (C + 1, n_pix) whose last row is the hit count."""
    _check(channels, pixel_ids)
    if channels.device.type == "cpu":
        return bin_map_plain(channels, pixel_ids, n_pix, count=count)
    if channels.device.type != "cuda":
        raise ValueError(f"bin_map runs on cpu or cuda tensors, not {channels.device.type}")
    if not (channels.is_contiguous() and pixel_ids.is_contiguous()):
        raise ValueError("channels and pixel_ids must be contiguous")
    if channels.shape[0] == 0 and not count:
        return torch.zeros((0, n_pix), dtype=torch.float32, device=channels.device)
    n_sm = _n_sm(channels.device.index if channels.device.index is not None else torch.cuda.current_device())
    plan = bin_plan(int(n_pix), channels.shape[0], pixel_ids.numel(), count, n_sm=n_sm)
    return launch(plan, channels, pixel_ids, n_pix)


bin_map.launches = 0
