"""Quantity: a value with units (maria_tpu/units/quantity.py).

Host numpy only: device code works on raw tensors in canonical SI units,
and a Quantity does the bookkeeping where a user hands one in.
Dimensionless results collapse to plain numpy arrays, as maria_tpu's do.
"""

from __future__ import annotations

import numpy as np

from .prefixes import best_prefix
from .units import DIMENSIONLESS, InvalidUnitsError, parse_units

__all__ = ["Quantity", "Angle", "as_radians"]


def lazy_nanquantile(x, q: float, laziness: int = 16, axis=None):
    """Approximate nanquantile from a strided subsample: cheap on
    multi-million-sample TODs."""
    return np.nanquantile(np.asarray(x).ravel()[::laziness], q=q, axis=axis)


class Quantity:
    def __new__(cls, value, units="", *args, **kwargs):
        u = parse_units(units)
        if u.is_dimensionless and u.factor == 1.0:
            return np.asarray(np.asarray(value, dtype=float))
        return super().__new__(cls)

    def __init__(self, value, units=""):
        if isinstance(value, Quantity):
            value = value.to(units).value
        self.u = parse_units(units)
        self.value = np.asarray(value, dtype=float)

    # -- conversion ----------------------------------------------------------
    def to(self, units) -> "Quantity":
        u = parse_units(units)
        out = Quantity.__new__(Quantity, 0.0, u)
        if isinstance(out, np.ndarray):  # dimensionless target
            return self.value * self.u.to(u)
        out.u = u
        out.value = self.value * self.u.to(u)
        return out

    def in_units(self, units) -> np.ndarray:
        """The raw value converted to `units`."""
        return self.value * self.u.to(parse_units(units))

    @property
    def physical_quantity(self) -> str | None:
        """Name of the physical quantity this carries ('time',
        'frequency', ...), matched by dimension vector."""
        if self.u.quantity is not None:
            return self.u.quantity
        from .units import UNITS

        for entry in UNITS.values():
            if tuple(sorted(entry["dims"].items())) == self.u.dims:
                return entry["quantity"]
        return None

    def __getattr__(self, attr):
        # attribute access like q.Hz, q.m, q.deg converts units
        if attr.startswith("_") or attr in ("u", "value"):
            raise AttributeError(attr)
        try:
            u = parse_units(attr)
        except InvalidUnitsError:
            raise AttributeError(attr) from None
        try:
            converted = self.value * self.u.to(u)
        except InvalidUnitsError as e:
            raise AttributeError(str(e)) from None
        return converted if converted.ndim else float(converted)

    # -- numpy interop -------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.value, dtype=dtype)

    @property
    def shape(self):
        return self.value.shape

    @property
    def ndim(self):
        return self.value.ndim

    @property
    def units(self):
        return self.u.name

    def __len__(self):
        return len(self.value)

    def __iter__(self):
        for v in self.value:
            yield Quantity(v, self.u)

    def __getitem__(self, idx):
        return Quantity(self.value[idx], self.u)

    def __bool__(self):
        return bool(np.any(self.value))

    def __float__(self):
        return float(self.value)

    # -- reductions ----------------------------------------------------------
    def min(self, **kw):
        return Quantity(self.value.min(**kw), self.u)

    def max(self, **kw):
        return Quantity(self.value.max(**kw), self.u)

    def mean(self, **kw):
        return Quantity(self.value.mean(**kw), self.u)

    def sum(self, **kw):
        return Quantity(self.value.sum(**kw), self.u)

    def ptp(self):
        return Quantity(np.ptp(self.value), self.u)

    # -- arithmetic ----------------------------------------------------------
    @staticmethod
    def _coerce(other):
        if isinstance(other, Quantity):
            return other.value, other.u
        return np.asarray(other), DIMENSIONLESS

    def _new(self, value, unit):
        if unit.is_dimensionless:
            return np.asarray(np.asarray(value, dtype=float) * unit.factor)
        q = Quantity.__new__(Quantity, 0.0, unit)
        q.u, q.value = unit, np.asarray(value, dtype=float)
        return q

    def __add__(self, other):
        v, u = self._coerce(other)
        if u.is_dimensionless and not self.u.is_dimensionless and np.all(v == 0):
            return Quantity(self.value, self.u)
        return Quantity(self.value + v * u.to(self.u), self.u)

    __radd__ = __add__

    def __sub__(self, other):
        v, u = self._coerce(other)
        return Quantity(self.value - v * u.to(self.u), self.u)

    def __rsub__(self, other):
        v, u = self._coerce(other)
        return Quantity(v * u.to(self.u) - self.value, self.u)

    def __mul__(self, other):
        v, u = self._coerce(other)
        return self._new(self.value * v, self.u * u)

    __rmul__ = __mul__

    def __truediv__(self, other):
        v, u = self._coerce(other)
        return self._new(self.value / v, self.u / u)

    def __rtruediv__(self, other):
        v, u = self._coerce(other)
        return self._new(v / self.value, u / self.u)

    def __pow__(self, p):
        return self._new(self.value**p, self.u**p)

    def __neg__(self):
        return Quantity(-self.value, self.u)

    def __abs__(self):
        return Quantity(np.abs(self.value), self.u)

    def _cmp(self, other, op):
        v, u = self._coerce(other)
        if not u.is_dimensionless:
            v = v * u.to(self.u)
        return op(self.value, v)

    def __lt__(self, other):
        return self._cmp(other, np.less)

    def __le__(self, other):
        return self._cmp(other, np.less_equal)

    def __gt__(self, other):
        return self._cmp(other, np.greater)

    def __ge__(self, other):
        return self._cmp(other, np.greater_equal)

    def __eq__(self, other):
        try:
            return self._cmp(other, np.equal)
        except InvalidUnitsError:
            return NotImplemented

    def __hash__(self):
        return hash((self.value.tobytes(), self.u.dims, self.u.factor))

    # -- display -------------------------------------------------------------
    def humanized(self):
        """Pick the best SI prefix for display."""
        base = self.u.base
        if base is None or not parse_units(base).factor == self.u.factor:
            # non-trivially scaled or compound: display as-is
            return self.value, self.u.name
        scale = self.value[np.isfinite(self.value)].std() if self.value.ndim else self.value
        ref = float(np.abs(scale)) if np.ndim(scale) == 0 else float(np.abs(scale).max())
        if self.value.ndim and ref == 0:
            ref = float(np.abs(self.value).max() or 1.0)
        symbol, factor = best_prefix(ref if ref else 1.0)
        if base in ("deg", "arcmin", "arcsec", "rad") and base != "rad":
            return self.value, base  # don't prefix sexagesimal-ish angles
        return self.value / factor, f"{symbol}{base}"

    def __format__(self, spec):
        v, unit_name = self.humanized()
        if np.ndim(v) == 0:
            return f"{float(v):{spec or '.3g'}} {unit_name}".strip()
        return f"{np.asarray(v)} {unit_name}".strip()

    def __repr__(self):
        v, unit_name = self.humanized()
        if np.ndim(v) == 0:
            return f"{float(v):.3g} {unit_name}"
        return f"Quantity({np.array2string(np.asarray(v), precision=3, threshold=8)}, units='{unit_name}')"


class Angle(Quantity):
    """An angle with sexagesimal-aware display."""

    def __new__(cls, value, units="rad"):
        obj = object.__new__(cls)
        return obj

    def __init__(self, value, units="rad"):
        super().__init__(np.asarray(value, dtype=float), units)
        if self.u.dims != (("rad", 1.0),) and self.u.dims != (("rad", 1),):
            raise InvalidUnitsError(f"'{units}' is not an angle")

    def humanized(self):
        rad = self.value * self.u.to(parse_units("rad"))
        deg = np.degrees(rad)
        ref = float(np.abs(deg).max()) if np.ndim(deg) else abs(float(deg))
        if ref >= 1:
            return deg, "deg"
        if ref >= 1 / 60:
            return deg * 60, "arcmin"
        return deg * 3600, "arcsec"

    def __repr__(self):
        v, unit_name = self.humanized()
        if np.ndim(v) == 0:
            return f"{float(v):.4g} {unit_name}"
        return f"Angle({np.array2string(np.asarray(v), precision=3, threshold=8)}, units='{unit_name}')"


def as_radians(angle) -> float:
    """An angle as a float in radians: a Quantity (or Angle) converted, a
    number taken as radians already."""
    return float(angle.rad) if isinstance(angle, Quantity) else float(angle)
