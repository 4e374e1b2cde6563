"""A stage's band tables: ``csrc/band_tables.cu`` and its plain torch
version.

``band_tables(tables, pwv, el, mueller_I)`` returns the (n_rows, n_t)
field of one of ``TODProgram.fields``' band stages: on the rows of each
band, A(pwv, el) * mueller_I, plus B(pwv, el) * samples in the two-table
form, where A and B are the band's bilinear (pwv, el) tables as
``TableEval`` evaluates them (clipped to the table; uniform, log and
general axes). The atmospheric loading is the one-table form (A the
band's power table, at the coarse rate), the CMB stage the two-table form
(A the band's P(T_CMB), B its dP/dT_CMB and the band's static CMB
samples, at the fine rate). A band without tables leaves its rows at
zero, as do rows that no band holds. ``BandTables`` holds a stage's bands
on one device, built once.

On CPU tensors it runs the plain version (``band_tables_plain``: each
table through its ``TableEval``, band by band, as the program always
evaluated them); on CUDA tensors it launches the kernel, one launch for
up to ``max_bands()`` bands, bit-equal to the plain version on the card.
Where pwv or el requires a gradient, the call goes through an autograd
Function whose forward is the kernel and whose backward is the plain
version's VJP, recomputed: the gradients are the plain version's. The
tables, mueller_I and the samples are constants. The kernel replaces no
TPU kernel (see its source). ``band_tables.launches`` counts its
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..array.rows import device_rows
from ..band import axis_transform
from . import kernels
from .interp import TableEval

__all__ = ["BandStage", "BandTables", "band_tables", "band_tables_plain", "max_bands"]

_AXIS_KINDS = {"uniform": 0, "log": 1, "general": 2}


class BandStage(NamedTuple):
    """One band of a stage: its rows among the call's (increasing host
    indices), the sides of its (pwv, el) grid, its tables (one or two
    (n_pwv, n_el) arrays; none leaves the rows at zero) and, with two, its
    static samples, a (rows, n_t) float32 tensor on the stage's device."""

    rows: np.ndarray
    pwv_side: np.ndarray
    el_side: np.ndarray
    tables: tuple = ()
    samples: torch.Tensor = None


class BandAxis(ctypes.Structure):
    """``BandAxis`` in the kernel's source."""

    _fields_ = [("kind", ctypes.c_int), ("n", ctypes.c_int), ("origin", ctypes.c_float),
                ("inv_step", ctypes.c_float), ("side", ctypes.c_int), ("pad", ctypes.c_int)]


class BandDesc(ctypes.Structure):
    """``BandDesc`` in the kernel's source."""

    _fields_ = [
        ("samples", ctypes.c_void_p), ("index", ctypes.c_void_p), ("ld_samples", ctypes.c_longlong),
        ("block0", ctypes.c_longlong), ("n_rows", ctypes.c_int), ("row0", ctypes.c_int),
        ("n_tables", ctypes.c_int), ("floats", ctypes.c_int), ("n_floats", ctypes.c_int), ("pad", ctypes.c_int),
        ("x", BandAxis), ("y", BandAxis),
    ]


def _axis(side, floats: list, offset: int) -> BandAxis:
    """The kernel's axis for ``side``: its transform's constants as torch
    rounds them on the card (the origin as float32, the step's reciprocal
    taken in double), and a general axis's float32 points appended to
    ``floats`` at ``offset``."""
    transform = axis_transform(side)
    axis = BandAxis(kind=_AXIS_KINDS[transform[0]], n=len(side))
    if transform[0] == "general":
        axis.side = offset
        floats.append(np.asarray(side, dtype=np.float32))
    else:
        axis.origin, axis.inv_step = float(transform[1]), kernels.scalar_reciprocal(transform[2])
    return axis


class BandTables:
    """A stage's bands (``BandStage``) on ``device`` for calls on
    ``n_rows`` rows: each table as a ``TableEval`` for the plain version,
    and, at the first launch, the kernel's descriptors and packed floats."""

    def __init__(self, bands, n_rows: int, device):
        self.bands = list(bands)
        self.n_rows = int(n_rows)
        self.device = torch.empty(0, device=device).device  # "cuda" as the tensors' "cuda:0"
        counts = {len(b.tables) for b in self.bands} - {0}
        if len(counts) > 1 or not counts <= {1, 2}:
            raise ValueError(f"a stage's bands take one table each or two each, got {sorted(counts)}")
        self.n_tables = counts.pop() if counts else 1
        held, written = np.zeros(self.n_rows, dtype=np.int64), np.zeros(self.n_rows, dtype=bool)
        for b in self.bands:
            rows = np.asarray(b.rows, dtype=np.int64)
            if len(rows) and (rows.min() < 0 or rows.max() >= self.n_rows or np.any(np.diff(rows) <= 0)):
                raise ValueError(f"a band's rows must increase within the call's {self.n_rows} rows")
            shape = (len(b.pwv_side), len(b.el_side))
            if any(np.shape(t) != shape or min(shape) < 2 for t in b.tables):
                raise ValueError(f"a band's tables must be {shape}, each side of two points or more")
            if (b.samples is not None) != (len(b.tables) == 2):
                raise ValueError("a band takes static samples exactly where it has two tables")
            if b.samples is not None and tuple(b.samples.shape[:1]) != (len(rows),):
                raise ValueError(f"a band's samples must have its {len(rows)} rows, got {tuple(b.samples.shape)}")
            held[rows] += 1
            written[rows] = bool(b.tables)
        if (held > 1).any():
            raise ValueError("a row lies in more than one band")
        # the plain version starts from zeros unless the bands' tables write every row; the kernel,
        # which writes zeros in a band without tables, unless the bands hold every row
        self.covered, self.held = bool(written.all()), bool((held == 1).all())
        self.rows = [device_rows(np.asarray(b.rows, dtype=np.int64), self.device) for b in self.bands]
        self.evals = [tuple(TableEval(b.pwv_side, b.el_side, t, device=self.device) for t in b.tables)
                      for b in self.bands]
        self._plan = None

    def kernel_plan(self):
        """(descriptors, packed floats, shared, the index tensors they point to), built once."""
        if self._plan is None:
            lib = _library()
            descs = (BandDesc * len(self.bands))()
            chunks, offset, kept = [], 0, []
            for d, band, rows in zip(descs, self.bands, self.rows):
                d.n_rows = len(band.rows)
                if isinstance(rows, slice):
                    d.row0 = rows.start
                else:
                    index = rows.to(torch.int32)
                    kept.append(index)
                    d.index = index.data_ptr()
                if not band.tables:
                    continue
                floats = [np.stack([np.asarray(t, dtype=np.float32) for t in band.tables], axis=-1).reshape(-1)]
                d.x = _axis(band.pwv_side, floats, sum(map(len, floats)))
                d.y = _axis(band.el_side, floats, sum(map(len, floats)))
                d.n_tables, d.floats, d.n_floats = len(band.tables), offset, sum(map(len, floats))
                floats.append(np.zeros(-d.n_floats % 4, dtype=np.float32))  # the next band's floats 16-byte aligned
                chunks += floats
                offset += sum(map(len, floats))
                if band.samples is not None:
                    if band.samples.dtype != torch.float32 or band.samples.device != self.device or (
                            band.samples.ndim != 2 or band.samples.stride(1) != 1):
                        raise ValueError("a band's samples must be float32 rows with unit stride along t on "
                                         f"{self.device}")
                    d.samples, d.ld_samples = band.samples.data_ptr(), band.samples.stride(0)
            packed = torch.as_tensor(np.concatenate(chunks) if chunks else np.zeros(4, np.float32), device=self.device)
            shared = max((d.n_floats for d in descs), default=0) <= lib.maria_band_tables_smem_floats()
            self._plan = descs, packed, shared, kept
        return self._plan


def max_bands() -> int:
    """Bands the kernel takes in one launch."""
    return kernels.load().maria_band_tables_max_bands()


def _library():
    lib = kernels.load()
    if lib.maria_band_tables_desc_bytes() != ctypes.sizeof(BandDesc):
        raise RuntimeError("csrc/band_tables.cu's BandDesc and ops/band_tables.py's differ in size")
    return lib


def _field(tables, like, zeros: bool):
    shape = (tables.n_rows, like.shape[1])
    return (torch.zeros if zeros else torch.empty)(shape, dtype=torch.float32, device=like.device)


def band_tables_plain(tables: BandTables, pwv, el, mueller_I):
    """Plain torch version of ``band_tables``, on any device."""
    out = _field(tables, pwv, not tables.covered)
    for band, rows, evals in zip(tables.bands, tables.rows, tables.evals):
        if not evals:
            continue
        x, y = pwv[rows], el[rows]
        value = evals[0](x, y) * mueller_I[rows, None]
        if len(evals) == 2:
            value = value + evals[1](x, y) * band.samples
        out[rows] = value
    return out


def _launch(tables: BandTables, pwv, el, mueller_I):
    descs, packed, shared, _ = tables.kernel_plan()
    lib = _library()
    pwv, el = (x if x.stride(1) == 1 else x.contiguous() for x in (pwv, el))
    n_t = pwv.shape[1]
    for band in tables.bands:
        if band.samples is not None and band.samples.shape[1] != n_t:
            raise ValueError(f"a band's samples have {band.samples.shape[1]} samples, the call {n_t}")
    out = _field(tables, pwv, not tables.held)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(pwv.device).cuda_stream
    step = lib.maria_band_tables_max_bands()
    for start in range(0, len(descs), step):
        count = min(step, len(descs) - start)
        code = lib.maria_band_tables(
            ctypes.addressof(descs) + start * ctypes.sizeof(BandDesc), count, tables.n_tables, int(shared),
            packed.data_ptr(), pwv.data_ptr(), pwv.stride(0), el.data_ptr(), el.stride(0), mueller_I.data_ptr(), n_t,
            out.data_ptr(), out.stride(0), stream,
        )
        kernels.check(lib, code, "band_tables kernel launch")
        band_tables.launches += 1
    return out


class _BandTablesFn(torch.autograd.Function):
    """``forward``'s field as a function of pwv and el; the backward is the
    plain version's VJP, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, pwv, el, tables, mueller_I, forward):
        ctx.save_for_backward(pwv, el)
        ctx.tables, ctx.mueller_I = tables, mueller_I
        return forward(tables, pwv, el, mueller_I)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        pwv, el = ctx.saved_tensors
        with torch.enable_grad():
            x = pwv.detach().requires_grad_(ctx.needs_input_grad[0])
            y = el.detach().requires_grad_(ctx.needs_input_grad[1])
            out = band_tables_plain(ctx.tables, x, y, ctx.mueller_I)
            wanted = [t for t in (x, y) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True) if out.requires_grad else
                         [None] * len(wanted))
        return (next(grads) if x.requires_grad else None, next(grads) if y.requires_grad else None, None, None, None)


def _check(tables: BandTables, pwv, el, mueller_I):
    if pwv.ndim != 2 or el.shape != pwv.shape or tuple(mueller_I.shape) != (tables.n_rows,) or (
            pwv.shape[0] != tables.n_rows):
        raise ValueError(f"band_tables takes pwv and el ({tables.n_rows}, n_t) and mueller_I ({tables.n_rows},), got "
                         f"{tuple(pwv.shape)}, {tuple(el.shape)}, {tuple(mueller_I.shape)}")
    tensors = (pwv, el, mueller_I)
    if any(x.dtype != torch.float32 or x.device != tables.device for x in tensors):
        raise ValueError(f"band_tables takes float32 tensors on {tables.device}, got "
                         f"{[(x.dtype, str(x.device)) for x in tensors]}")
    if mueller_I.requires_grad:
        raise ValueError("band_tables takes a constant mueller_I: it requires a gradient")


def band_tables(tables: BandTables, pwv, el, mueller_I):
    """The stage's (n_rows, n_t) float32 field (module docstring): the
    plain version on CPU tensors, the kernel on CUDA ones."""
    _check(tables, pwv, el, mueller_I)
    if pwv.device.type == "cpu":
        return band_tables_plain(tables, pwv, el, mueller_I)
    if pwv.device.type != "cuda":
        raise ValueError(f"band_tables runs on cpu or cuda tensors, not {pwv.device.type}")
    mueller_I = mueller_I.contiguous()
    if torch.is_grad_enabled() and (pwv.requires_grad or el.requires_grad):
        return _BandTablesFn.apply(pwv, el, tables, mueller_I, _launch)
    return _launch(tables, pwv, el, mueller_I)


band_tables.launches = 0
