"""The exceptions of the units layer, the calibration graph and the
Simulation's keywords (maria_tpu/errors/__init__.py, units/units.py and
sim/params.py): the same names, base classes and messages, so that code
written for maria_tpu catches them by the same name."""

from __future__ import annotations

__all__ = [
    "IncompatibleQuantityError",
    "InvalidSimulationParameterError",
    "InvalidUnitsError",
    "MissingCalibrationKwargs",
    "MissingCalibrationKwargsError",
    "ShapeError",
    "UnitError",
]


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
