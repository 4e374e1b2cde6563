"""The package's exceptions (maria_tpu/errors/__init__.py, units/units.py
and sim/params.py): the same names, base classes and messages, so that
code written for maria_tpu catches them by the same name."""

from __future__ import annotations

from .constants import MAX_NU_HZ, MIN_NU_HZ

__all__ = [
    "ConfigurationError",
    "FrequencyOutOfBoundsError",
    "IncompatibleMapError",
    "IncompatibleQuantityError",
    "InvalidArrayError",
    "InvalidInstrumentError",
    "InvalidRegionError",
    "InvalidSimulationParameterError",
    "InvalidSiteError",
    "InvalidUnitsError",
    "MissingCalibrationKwargs",
    "MissingCalibrationKwargsError",
    "NoSuitablePlansError",
    "PointingError",
    "ShapeError",
    "UnitError",
]


class PointingError(Exception):
    pass


class IncompatibleMapError(Exception):
    """A map that cannot be observed the way it was passed (a HEALPix
    all-sky map given as ``map=``: pass it as ``cmb=`` or project it)."""


class ConfigurationError(Exception):
    """A bad scene or component configuration."""


class InvalidInstrumentError(ValueError):
    def __init__(self, name, valid=None):
        hint = f" Valid instruments are {sorted(valid)}." if valid else ""
        super().__init__(f"Invalid instrument '{name}'.{hint}")


class InvalidArrayError(ValueError):
    def __init__(self, name, valid=None):
        hint = f" Valid arrays are {sorted(valid)}." if valid else ""
        super().__init__(f"Invalid array '{name}'.{hint}")


class InvalidSiteError(ValueError):
    def __init__(self, name, valid=None):
        hint = f" Valid sites are {sorted(valid)}." if valid else ""
        super().__init__(f"Invalid site '{name}'.{hint}")


class InvalidRegionError(Exception):
    def __init__(self, region, valid=None):
        hint = f" Valid regions are {sorted(valid)}." if valid else ""
        super().__init__(f"Invalid region '{region}'.{hint}")


class FrequencyOutOfBoundsError(Exception):
    def __init__(self, nu=None, center_and_width=None):
        if center_and_width is not None:
            detail = f"band with center {center_and_width[0]:.3e} Hz and width {center_and_width[1]:.3e} Hz"
        else:
            detail = f"frequencies {nu}"
        super().__init__(
            f"The {detail} fall outside the supported range [{MIN_NU_HZ:.0e}, {MAX_NU_HZ:.0e}] Hz.",
        )


class NoSuitablePlansError(Exception):
    def __init__(self, message="Could not find any plans satisfying the given constraints."):
        super().__init__(message)


class ShapeError(Exception):
    pass


class MissingCalibrationKwargsError(Exception):
    def __init__(self, missing):
        super().__init__(f"Missing required calibration kwargs {missing}.")


# the reference's name for the same exception
MissingCalibrationKwargs = MissingCalibrationKwargsError


class IncompatibleQuantityError(Exception):
    pass


class InvalidUnitsError(ValueError):
    def __init__(self, units, message=None):
        super().__init__(
            message or f"Invalid units '{units}'. See maria_torch.units.UNITS for supported units.",
        )


# the reference's parser raises UnitError; both names catch the same exceptions
UnitError = InvalidUnitsError


class InvalidSimulationParameterError(Exception):
    def __init__(self, invalid_keys):
        from .sim.params import MASTER_PARAMS

        super().__init__(
            f"The parameters {invalid_keys} are not valid simulation parameters! "
            f"Valid loose parameters per subsystem: {MASTER_PARAMS}",
        )
