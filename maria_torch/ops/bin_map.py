"""Map binning: kernel K2 and its plain torch version.

``bin_map(channels, pixel_ids, n_pix)`` sums each channel of
(C, n_det, n_t) float32 data into a (C, n_pix) map at the flat pixel ids
(n_det, n_t) int32; ids outside [0, n_pix) (-1 marks off-map samples)
are skipped. On a CUDA tensor it launches ``csrc/bin_map.cu`` (which
replaces maria_tpu's ``bin_blocked_pallas``); on a CPU tensor it runs the
plain version, ``index_add_``. The kernel sums with atomics, so the
order of the additions, and the last bits of a sum, vary from run to run.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["bin_map", "bin_map_plain"]


def _check(channels, pixel_ids):
    if channels.ndim != 3 or channels.dtype != torch.float32:
        raise ValueError(f"channels must be float32 (C, n_det, n_t), got {channels.dtype} {tuple(channels.shape)}")
    if pixel_ids.dtype != torch.int32 or tuple(pixel_ids.shape) != tuple(channels.shape[1:]):
        raise ValueError(
            f"pixel_ids must be int32 {tuple(channels.shape[1:])}, got {pixel_ids.dtype} {tuple(pixel_ids.shape)}"
        )
    if channels.device != pixel_ids.device:
        raise ValueError("channels and pixel_ids must be on the same device")


def bin_map_plain(channels, pixel_ids, n_pix: int):
    """Plain torch version: index_add_ along the flat pixel axis."""
    _check(channels, pixel_ids)
    ids = pixel_ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < n_pix)
    data = channels.reshape(channels.shape[0], -1)[:, keep]
    out = torch.zeros((channels.shape[0], n_pix), dtype=torch.float32, device=channels.device)
    return out.index_add_(1, ids[keep], data)


def bin_map(channels, pixel_ids, n_pix: int):
    """(C, n_pix) float32 sums of each channel at each pixel."""
    _check(channels, pixel_ids)
    if channels.device.type == "cpu":
        return bin_map_plain(channels, pixel_ids, n_pix)
    if channels.device.type != "cuda":
        raise ValueError(f"bin_map runs on cpu or cuda tensors, not {channels.device.type}")
    if not (channels.is_contiguous() and pixel_ids.is_contiguous()):
        raise ValueError("channels and pixel_ids must be contiguous")
    n_channels = channels.shape[0]
    n_samples = pixel_ids.numel()
    out = torch.zeros((n_channels, n_pix), dtype=torch.float32, device=channels.device)
    if n_samples == 0 or n_channels == 0:
        return out
    lib = kernels.load()
    n_blocks = int(min(-(-n_samples // 256), 132 * 16))
    stream = torch.cuda.current_stream(channels.device).cuda_stream
    code = lib.maria_bin_map(
        channels.data_ptr(), pixel_ids.data_ptr(), out.data_ptr(), n_samples, n_channels, int(n_pix),
        n_blocks, stream,
    )
    kernels.check(lib, code, "bin_map kernel launch")
    bin_map.launches += 1
    return out


bin_map.launches = 0
