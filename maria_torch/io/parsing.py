"""The parsers of a user's axes (maria_tpu/io/parsing.py): time,
frequency, velocity and Stokes. Each accepts bare floats (in the
canonical unit) or ``Quantity`` values of compatible dimensions and
returns a float64 array in the canonical unit (s, Hz, m s^-1)."""

from __future__ import annotations

import numpy as np

from ..units import Quantity, parse_units
from ..utils import is_integer, is_numeric


def _parse_dimensioned(x, name: str, canonical: str, quantity_name: str):
    values = []
    for value in np.atleast_1d(x):
        if isinstance(value, Quantity):
            if not value.u.is_compatible(parse_units(canonical)):
                raise ValueError(
                    f"'{name}' has units of {value.units} which are incompatible with {quantity_name}"
                )
            values.append(value.in_units(canonical))
        elif is_numeric(value):
            values.append(float(value))
        else:
            raise ValueError(
                f"'{name}' must be either an array of floats (assumed to be in units of "
                f"{canonical}) or a Quantity with dimensions of {quantity_name}"
            )
    return np.array(values, dtype=float)


def parse_t(t):
    """Times in seconds (bare floats are a UNIX epoch)."""
    # a Quantity passed whole carries one unit for all elements
    if isinstance(t, Quantity):
        if not t.u.is_compatible(parse_units("s")):
            raise ValueError(f"'t' has units of {t.units} which are incompatible with time")
        return np.atleast_1d(np.asarray(t.in_units("s"), dtype=float))
    return _parse_dimensioned(t, "t", "s", "time")


def parse_nu(nu):
    """Frequencies in Hz."""
    if isinstance(nu, Quantity):
        if not nu.u.is_compatible(parse_units("Hz")):
            raise ValueError(f"'nu' has units of {nu.units} which are incompatible with frequency")
        return np.atleast_1d(np.asarray(nu.in_units("Hz"), dtype=float))
    return _parse_dimensioned(nu, "nu", "Hz", "frequency")


def parse_v(v):
    """Velocities in m/s."""
    if isinstance(v, Quantity):
        if not v.u.is_compatible(parse_units("m/s")):
            raise ValueError(f"'v' has units of {v.units} which are incompatible with velocity")
        return np.atleast_1d(np.asarray(v.in_units("m/s"), dtype=float))
    return _parse_dimensioned(v, "v", "m/s", "velocity")


def parse_stokes(stokes):
    """Normalize Stokes parameters to an array of 'I'/'Q'/'U'/'V'
    characters; accepts a string like 'IQU' or integer indices."""
    if isinstance(stokes, str):
        stokes = list(stokes)
    stokes_list = []
    for s in np.atleast_1d(stokes):
        if isinstance(s, str) and s.upper() in "IQUV" and len(s) == 1:
            stokes_list.append(s.upper())
        elif not isinstance(s, str) and np.ndim(is_integer(s)) == 0 and is_integer(s):
            idx = int(s)
            if not 0 <= idx < 4:
                stokes_list = None
                break
            stokes_list.append("IQUV"[idx])
        else:
            stokes_list = None
            break
    if stokes_list is None:
        raise ValueError(
            f"Invalid Stokes parameters '{stokes}' (must be an iterable of parameters "
            "in ['I', 'Q', 'U', 'V'] or [0, 1, 2, 3])"
        )
    return np.array(stokes_list)
