"""Unit parsing and algebra (maria_tpu/units/units.py).

Units are dimension vectors over a small set of base axes; the
"flavoured" temperatures (K_RJ, K_CMB, K_b) and the per-beam and
per-pixel flux densities get their own axes, since converting between
them is physics (the calibration graph), not unit algebra. Each named
unit carries its quantity name, on which the graph dispatches.

Grammar:
    unit     := term (('*' | '/' | whitespace) term)*
    term     := '√'? prefix? name ('^' | '**')? exponent?
Examples: "uK_RJ", "W√s", "rad/s", "Jy/beam", "mm", "K_RJ√s", "m^2".
"""


import re
from dataclasses import dataclass, field

from ..errors import InvalidUnitsError, UnitError

__all__ = ["Unit", "parse_units", "UNITS", "InvalidUnitsError", "UnitError", "QUANTITIES",
           "QUANTITY_DIMENSION_VECTORS"]


def repr_power(thing: str, power: float, math: bool = False) -> str:
    """Render 'thing^power', eliding trivial exponents."""
    power = float(power)
    if power == 0:
        return ""
    if power == 1:
        return thing
    exp_numer, exp_denom = power.as_integer_ratio()
    if exp_numer % exp_denom:
        exp_string = f"{exp_numer}/{exp_denom}" if math else f"{power}"
    else:
        exp_string = f"{int(exp_numer / exp_denom)}"
    if math:
        exp_string = f"{{{exp_string}}}"
    return f"{thing}^{exp_string}"


def repr_dim_vec(dim_vec) -> str:
    """Render a dimension vector (mapping or (axis, power) pairs) as a
    unit string."""
    items = dim_vec.items() if hasattr(dim_vec, "items") else dim_vec
    parts = [repr_power(unit, power) for unit, power in items]
    return " ".join(p for p in parts if p)


# base dimension axes
# fmt: off
BASE_DIMS = (
    "m", "s", "kg", "K", "rad",          # mechanical + angle
    "K_RJ", "K_CMB", "K_b",              # calibrated temperature flavors
    "Jy_pixel", "Jy_beam", "Jy_sr",      # flux-density flavors
    "y",                                 # compton y
    "pixel", "beam",
)
# fmt: on

# name -> (factor to canonical, dims dict, quantity name, math name)
UNITS: dict[str, dict] = {}


def _register(name, factor, dims, quantity, math_name=None, aliases=(), prefixable=True):
    entry = {
        "factor": float(factor),
        "dims": dict(dims),
        "quantity": quantity,
        "math_name": math_name or name,
        "prefixable": prefixable,
        "base": name,
    }
    UNITS[name] = entry
    for alias in aliases:
        UNITS[alias] = {**entry, "prefixable": False}


_register("m", 1, {"m": 1}, "length", aliases=("meter", "meters"))
_register("s", 1, {"s": 1}, "time", aliases=("second", "seconds"))
_register("min", 60, {"s": 1}, "time", prefixable=False)
_register("hr", 3600, {"s": 1}, "time", prefixable=False, aliases=("hour", "hours"))
_register("day", 86400, {"s": 1}, "time", prefixable=False, aliases=("days",))
_register("g", 1e-3, {"kg": 1}, "mass", aliases=("gram", "grams"))
_register("K", 1, {"K": 1}, "temperature", aliases=("Kelvin",))
_register("rad", 1, {"rad": 1}, "angle", math_name="\\text{rad}", aliases=("radian", "radians"))
_register("deg", 3.141592653589793 / 180, {"rad": 1}, "angle", math_name="^\\circ",
          prefixable=False, aliases=("degree", "degrees", "°"))
_register("arcmin", 3.141592653589793 / 180 / 60, {"rad": 1}, "angle", prefixable=False, aliases=("'",))
_register("arcsec", 3.141592653589793 / 180 / 3600, {"rad": 1}, "angle", prefixable=False, aliases=('"',))
_register("Hz", 1, {"s": -1}, "frequency")
_register("W", 1, {"kg": 1, "m": 2, "s": -3}, "power", aliases=("watt", "watts"))
_register("J", 1, {"kg": 1, "m": 2, "s": -2}, "energy")
_register("sr", 1, {"rad": 2}, "solid_angle", prefixable=False)
_register("K_RJ", 1, {"K_RJ": 1}, "rayleigh_jeans_temperature", math_name="K_{RJ}")
_register("K_CMB", 1, {"K_CMB": 1}, "cmb_temperature_anisotropy", math_name="K_{CMB}")
_register("K_b", 1, {"K_b": 1}, "brightness_temperature", math_name="K_{b}")
_register("Jy/pixel", 1, {"Jy_pixel": 1}, "spectral_flux_density_per_pixel", math_name="Jy/\\text{pixel}")
_register("Jy/beam", 1, {"Jy_beam": 1}, "spectral_flux_density_per_beam", math_name="Jy/\\text{beam}")
_register("Jy/sr", 1, {"Jy_sr": 1}, "spectral_radiance", math_name="Jy/\\text{sr}")
_register("y", 1, {"y": 1}, "compton_y", prefixable=False, aliases=("compton_y",))
_register("pixel", 1, {"pixel": 1}, "pixel", prefixable=False, aliases=("pixels",))
_register("beam", 1, {"beam": 1}, "beam", prefixable=False, aliases=("beams",))

# sorted longest-first for greedy tokenization
_UNIT_NAMES = sorted(UNITS, key=len, reverse=True)

# prefix symbols, longest first
from .prefixes import SYMBOL_TO_FACTOR  # noqa: E402

_PREFIX_SYMBOLS = sorted(SYMBOL_TO_FACTOR, key=len, reverse=True)

# body may contain '/' (protected slash-named units like 'Jy/beam' survive
# tokenization intact); exponent '/' is unambiguous after '^' or '**'
_TERM_RE = re.compile(
    r"^(?P<sqrt>√|sqrt_)?(?P<body>[^\^*√]+?)(?:(?:\^|\*\*)(?P<exp>[+-]?\d+(?:\.\d+)?(?:/\d+)?))?$"
)


@dataclass(frozen=True)
class Unit:
    """A parsed unit: a scale factor and a dimension vector."""

    name: str
    factor: float
    dims: tuple  # sorted tuple of (axis, exponent)
    quantity: str | None = None
    math_name: str = ""
    base: str | None = field(default=None, compare=False)

    @property
    def dims_dict(self):
        return dict(self.dims)

    def is_compatible(self, other: "Unit") -> bool:
        return self.dims == other.dims

    def to(self, other: "Unit") -> float:
        """Multiplicative factor converting a value in self to a value in other."""
        if not self.is_compatible(other):
            raise InvalidUnitsError(
                None, message=f"Cannot convert '{self.name}' to '{other.name}' (incompatible dimensions).",
            )
        return self.factor / other.factor

    def __mul__(self, other: "Unit") -> "Unit":
        dims = dict(self.dims)
        for axis, exp in other.dims:
            dims[axis] = dims.get(axis, 0) + exp
        dims = {k: v for k, v in dims.items() if v != 0}
        return Unit(
            name=" ".join(n for n in (self.name, other.name) if n),
            factor=self.factor * other.factor,
            dims=tuple(sorted(dims.items())),
        )

    def __truediv__(self, other: "Unit") -> "Unit":
        return self * other**-1

    def __pow__(self, p) -> "Unit":
        dims = {axis: exp * p for axis, exp in self.dims}
        dims = {k: v for k, v in dims.items() if v != 0}
        name = self.name if (p == 1 or not self.name) else f"{self.name}^{p}"
        return Unit(name=name, factor=self.factor**p, dims=tuple(sorted(dims.items())))

    @property
    def is_dimensionless(self):
        return len(self.dims) == 0

    def __repr__(self):
        return f"Unit('{self.name}')"


DIMENSIONLESS = Unit(name="", factor=1.0, dims=())


def _parse_body(body: str):
    """Resolve 'uK_RJ' -> (1e-6, UNITS['K_RJ']). Longest unit name wins."""
    if body in UNITS:
        return 1.0, UNITS[body]
    for name in _UNIT_NAMES:
        if body.endswith(name) and UNITS[name]["prefixable"]:
            prefix = body[: -len(name)]
            if prefix in SYMBOL_TO_FACTOR:
                return SYMBOL_TO_FACTOR[prefix], UNITS[name]
    raise InvalidUnitsError(body)


def _parse_term(term: str) -> Unit:
    m = _TERM_RE.match(term)
    if m is None:
        raise InvalidUnitsError(term)
    prefactor, entry = _parse_body(m.group("body"))
    exp = 1.0
    if m.group("exp"):
        e = m.group("exp")
        exp = float(e.split("/")[0]) / float(e.split("/")[1]) if "/" in e else float(e)
    if m.group("sqrt"):
        exp *= 0.5
    dims = {k: v * exp for k, v in entry["dims"].items()}
    return Unit(
        name=term,
        factor=(prefactor * entry["factor"]) ** exp,
        dims=tuple(sorted(dims.items())),
        quantity=entry["quantity"] if exp == 1 else None,
        math_name=entry["math_name"],
        base=entry["base"] if exp == 1 else None,
    )


def _tokenize(units: str):
    """Split a unit string into (operator, term) pairs."""
    # normalize: '**' handled inside terms; protect 'Jy/pixel'-style named units
    protected = {}
    for i, name in enumerate(n for n in _UNIT_NAMES if "/" in n):
        key = f"\x00{i}\x00"
        protected[key] = name
    s = units.strip()
    for key, name in protected.items():
        s = s.replace(name, key)

    tokens = []
    op = "*"
    buf = ""
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in "*/" and not (ch == "*" and i + 1 < len(s) and s[i + 1] == "*"):
            if buf.strip():
                tokens.append((op, buf.strip()))
                buf = ""
            op = ch
            i += 1
        elif ch == "*" and i + 1 < len(s) and s[i + 1] == "*":
            buf += "**"
            i += 2
        elif ch == " ":
            if buf.strip():
                tokens.append((op, buf.strip()))
                buf = ""
                op = "*"
            i += 1
        elif ch == "√" and buf.strip():
            # mid-token √ starts a new multiplied term, e.g. "W√s"
            tokens.append((op, buf.strip()))
            buf = "√"
            op = "*"
            i += 1
        else:
            buf += ch
            i += 1
    if buf.strip():
        tokens.append((op, buf.strip()))

    out = []
    for op, term in tokens:
        for key, name in protected.items():
            term = term.replace(key, name)
        out.append((op, term))
    return out


def parse_units(units: str | Unit) -> Unit:
    """Parse a unit string into a Unit."""
    if isinstance(units, Unit):
        return units
    if units is None or units == "":
        return DIMENSIONLESS
    result = None
    for op, term in _tokenize(str(units)):
        u = _parse_term(term)
        if result is None:
            result = u if op == "*" else u**-1
        else:
            result = result * u if op == "*" else result / u
    if result is None:
        raise InvalidUnitsError(units)
    return Unit(
        name=str(units),
        factor=result.factor,
        dims=result.dims,
        quantity=result.quantity,
        math_name=result.math_name,
        base=result.base,
    )


QUANTITIES = sorted({e["quantity"] for e in UNITS.values() if e["quantity"]})
# quantity -> its dimension vector (maria_tpu keeps the same as a table)
QUANTITY_DIMENSION_VECTORS = {}
for _entry in UNITS.values():
    if _entry["quantity"] is not None:
        QUANTITY_DIMENSION_VECTORS.setdefault(_entry["quantity"], dict(_entry["dims"]))
