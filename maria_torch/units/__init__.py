"""Units and quantities (maria_tpu/units): ``parse_units`` reads a unit
string into a scale and a dimension vector, ``Quantity`` carries a value
with its units. Host numpy; ``Calibration`` converts between quantities."""

from .prefixes import PREFIXES, best_prefix  # noqa: F401
from .quantity import Angle, Quantity, as_radians  # noqa: F401
from .units import UNITS, InvalidUnitsError, Unit, parse_units  # noqa: F401

__all__ = ["Quantity", "Angle", "Unit", "parse_units", "UNITS", "PREFIXES", "best_prefix", "InvalidUnitsError"]
