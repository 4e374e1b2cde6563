"""The map base (maria_tpu/map/base.py): units and their conversion, and
the slice dimensions.

A map's units name one of ``VALID_MAP_QUANTITIES``: the temperatures,
the flux densities, the spectral radiance, compton y, and (for the
mappers' maps of TODs in pW) power. ``to`` converts through the
calibration graph, one call per frequency channel. Every map carries its
three slice dimensions (stokes, nu and one labelled t, z or v) whatever
their size: ``squeeze``, ``unsqueeze``, ``dims``, ``apply_parity`` and
``concatenate`` work on them as maria_tpu's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_float32
from ..units import parse_units

__all__ = ["Map", "SLICE_DIMS", "STOKES_ORDER", "VALID_MAP_QUANTITIES", "check_map_units", "concatenate"]

STOKES_ORDER = "IQUV"

VALID_MAP_QUANTITIES = [
    "rayleigh_jeans_temperature",
    "cmb_temperature_anisotropy",
    "brightness_temperature",
    "spectral_flux_density_per_pixel",
    "spectral_flux_density_per_beam",
    "spectral_radiance",
    "compton_y",
    "power",
]


# the leading (non-map) dims: dtype and default of each; the third slot
# carries one labelled axis, time t, redshift z or velocity v
SLICE_DIMS = {
    "stokes": {"dtype": str, "default": "I"},
    "nu": {"dtype": float, "default": 150e9},
    "t": {"dtype": float, "default": 0.0},
    "z": {"dtype": float, "default": 0.0},
    "v": {"dtype": float, "default": 0.0},
}
_SLICE_AXIS = {"stokes": 0, "nu": 1, "t": 2, "z": 2, "v": 2}


def check_map_units(units: str) -> str:
    u = parse_units(units)
    if u.quantity not in VALID_MAP_QUANTITIES:
        raise ValueError(f"Invalid map units '{units}' (quantity '{u.quantity}').")
    return units


def _as_float32(x):
    """A float32 tensor of ``x``; a tensor stays on its device."""
    return x.to(torch.float32) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), dtype=torch.float32)


class Map:
    """What the map classes share: ``data`` and ``weight`` tensors of
    shape (stokes, nu, t, *map dims), ``nu`` in Hz and ``units``. The
    constructor puts missing slice axes where the metadata says they
    belong ((stokes, nu, pixels) becomes (stokes, nu, 1, pixels)); the
    third slice axis carries one label, time ``t`` (the default),
    redshift ``z`` or velocity ``v``. A tensor's data stay on their
    device; anything else lands on the host. ``dtype`` must be float32;
    ``degrees`` is the subclasses' (their centre and sizes)."""

    map_dims: tuple = ()
    axis3_label = "t"

    def __init__(self, data, stokes: str = None, nu=None, t=None, z=None, v=None, units: str = "K_RJ", weight=None,
                 dtype=torch.float32, degrees: bool = True):
        check_float32(dtype)
        self.units = check_map_units(units)
        data = _as_float32(data)
        n_dims = len(self.map_dims) + 3
        given = {k: val for k, val in (("t", t), ("z", z), ("v", v)) if val is not None}
        if len(given) > 1:
            raise ValueError(f"Give at most one of t/z/v (got {sorted(given)}).")
        self.axis3_label = next(iter(given), "t")
        axis3 = given.get(self.axis3_label)
        if data.ndim > n_dims:
            raise ValueError(f"Map data has too many dims ({data.ndim}).")
        if data.ndim < n_dims:
            target = (
                len(stokes) if stokes else 1,
                len(np.atleast_1d(nu)) if nu is not None else 1,
                len(np.atleast_1d(axis3)) if axis3 is not None else 1,
                *data.shape[3 - n_dims:],
            )
            if data.numel() == int(np.prod(target)):
                data = data.reshape(target)
            else:
                data = data.reshape((1,) * (n_dims - data.ndim) + tuple(data.shape))
        self.data = data

        self.stokes = stokes or STOKES_ORDER[: data.shape[0]]
        if len(self.stokes) != data.shape[0]:
            raise ValueError(f"Stokes '{self.stokes}' does not match data shape {tuple(data.shape)}.")
        self.nu = np.atleast_1d(np.asarray(nu if nu is not None else [150e9], dtype=float))
        if len(self.nu) != data.shape[1]:
            raise ValueError(f"nu axis ({len(self.nu)}) does not match data shape {tuple(data.shape)}.")
        self.t = np.atleast_1d(np.asarray(axis3 if axis3 is not None else [0.0], dtype=float))
        if len(self.t) != data.shape[2]:
            raise ValueError(f"{self.axis3_label} axis ({len(self.t)}) does not match data shape {tuple(data.shape)}.")
        self.weight = None if weight is None else _as_float32(weight).reshape(data.shape)

    # -- structure ----------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def n_stokes(self) -> int:
        return len(self.stokes)

    @property
    def n_nu(self) -> int:
        return len(self.nu)

    @property
    def z(self):
        """The redshift axis, where the third slice axis is labelled z."""
        if self.axis3_label != "z":
            raise AttributeError(f"This map's third slice axis is '{self.axis3_label}', not 'z'.")
        return self.t

    @property
    def v(self):
        """The velocity axis, where the third slice axis is labelled v."""
        if self.axis3_label != "v":
            raise AttributeError(f"This map's third slice axis is '{self.axis3_label}', not 'v'.")
        return self.t

    @property
    def nu_bin_bounds(self):
        """(nu_min, nu_max) in Hz of every channel: the midpoints between
        adjacent nu; one channel takes every frequency (maria_tpu gives
        the same bounds as Quantities)."""
        if self.n_nu == 1:
            return [(0.0, np.inf)]
        edges = [0.0, *(0.5 * (self.nu[1:] + self.nu[:-1])), np.inf]
        return list(zip(edges[:-1], edges[1:]))

    def _calibration_kwargs(self) -> dict:
        return {}

    def _replace(self, **kwargs):
        raise NotImplementedError

    def to(self, units: str, band=None):
        """The map in ``units``, converted per frequency channel with the
        channel's ``nu``, the pixel area and ``band``. The weights are
        inverse variances, so they scale by 1/slope^2 of the conversion:
        the factor of a linear chain, else the finite-difference slope at
        each pixel (maria_tpu/map/base.py:173-203)."""
        new, old = parse_units(units), parse_units(self.units)
        if new.dims == old.dims and new.factor == old.factor:
            return self
        from ..calibration import Calibration

        weight = self.weight
        new_data, new_weight = [], []
        for i, nu in enumerate(self.nu):
            cal = Calibration(f"{self.units} -> {units}", nu=float(nu), band=band, **self._calibration_kwargs())
            if cal.linear():
                factor = float(np.asarray(cal(1.0)))
                new_data.append(self.data[:, i] * factor)
                new_weight.append(None if weight is None else weight[:, i] / factor**2)
                continue
            # a non-linear chain on the host in float64, back onto the map's device
            x = self.data[:, i].double().cpu().numpy()
            y = np.asarray(cal(x))
            new_data.append(torch.as_tensor(y, dtype=torch.float32, device=self.data.device))
            if weight is not None:
                eps = 1e-6 * max(float(np.abs(x).max()), 1e-30)
                slope = (np.asarray(cal(x + eps)) - y) / eps
                w = weight[:, i].double().cpu().numpy() / (slope**2 + 1e-300)
                new_weight.append(torch.as_tensor(w, dtype=torch.float32, device=weight.device))
        return self._replace(
            data=torch.stack(new_data, dim=1),
            weight=None if weight is None else torch.stack(new_weight, dim=1),
            units=units,
        )

    # -- slice dimensions ---------------------------------------------------------------
    def squeeze(self, dim: str) -> "Map":
        """The map itself: every slice dim is always carried, so squeezing
        one of size 1 changes nothing (a larger one raises)."""
        axis = _SLICE_AXIS[dim]
        if self.data.shape[axis] != 1:
            raise ValueError(f"Cannot squeeze dim '{dim}' of size {self.data.shape[axis]}.")
        return self

    def unsqueeze(self, dim: str, value=None) -> "Map":
        """The map with the coordinate ``value`` given to its dim ``dim`` of
        size 1 (``m.unsqueeze("nu", 150e9)`` tags a map with its
        frequency); the map itself without a value. Only the default third
        axis (t = [0]) may be relabelled z or v."""
        if value is None:
            return self
        axis = _SLICE_AXIS[dim]
        if self.data.shape[axis] != 1:
            raise ValueError(f"Cannot assign a single {dim}={value} to a {dim} axis of size {self.data.shape[axis]}.")
        if dim == "nu":
            return self._replace(nu=np.atleast_1d(float(value)))
        if dim == "stokes":
            return self._replace(stokes=str(value))
        if dim != self.axis3_label and not (self.axis3_label == "t" and len(self.t) == 1 and self.t[0] == 0.0):
            raise ValueError(f"Cannot relabel axis '{self.axis3_label}' as '{dim}'.")
        return self._replace(**{dim: np.atleast_1d(float(value))})

    @property
    def dims(self) -> dict:
        """The size of every dim by name, the slice dims first."""
        return {"stokes": len(self.stokes), "nu": len(self.nu), self.axis3_label: len(self.t),
                **dict(zip(self.map_dims, self.data.shape[3:]))}

    def apply_parity(self, **signs) -> "Map":
        """Flip the map dims given a sign of -1 (``apply_parity(xi=-1)``),
        data and weight, in place; the map itself, for chaining."""
        flips = [3 + i for i, dim in enumerate(self.map_dims) if signs.get(dim, 1) == -1]
        if flips:
            self.data = torch.flip(self.data, dims=flips)
            if self.weight is not None:
                self.weight = torch.flip(self.weight, dims=flips)
        return self

    @classmethod
    def concatenate(cls, maps: list, dim: str = "t") -> "Map":
        """The maps joined along the slice dim ``dim``, on the first map's
        device, with the first map's geometry and units."""
        axis = _SLICE_AXIS[dim]
        first = maps[0]
        device = first.data.device
        data = torch.cat([m.data.to(device) for m in maps], dim=axis)
        weights = [m.weight for m in maps]
        weight = (None if any(w is None for w in weights)
                  else torch.cat([w.to(device) for w in weights], dim=axis))
        kwargs = {}
        if dim == "nu":
            kwargs["nu"] = np.concatenate([m.nu for m in maps])
        elif axis == 2:
            if any(m.axis3_label != dim for m in maps):
                raise ValueError(f"Not every map's third axis is labeled '{dim}'.")
            kwargs[dim] = np.concatenate([m.t for m in maps])
        else:
            kwargs["stokes"] = "".join(m.stokes for m in maps)
        return first._replace(data=data, weight=weight, **kwargs)


def concatenate(maps: list, dim: str = "t") -> Map:
    """The maps joined along the slice dim ``dim`` (``Map.concatenate``)."""
    return type(maps[0]).concatenate(maps, dim=dim)
