"""Scan plans (maria_tpu/plan): ``Plan`` and ``PlanList``, the scan
patterns, the six named plans of the registry, and the constraint-based
``Planner``. ``get_plan`` takes a registry name, a bare pattern name
("daisy", built by ``Plan.generate(scan_pattern=...)``) or no name."""

from __future__ import annotations

from ..io import read_config
from .patterns import SCAN_PATTERNS, all_patterns, get_scan_pattern_generator, parse_scan_kwargs  # noqa: F401
from .plan import Plan, PlanList, parse_time  # noqa: F401
from .planner import NoSuitablePlansError, Planner  # noqa: F401

__all__ = ["NoSuitablePlansError", "PLAN_CONFIGS", "Plan", "PlanList", "Planner", "SCAN_PATTERNS",
           "UnsupportedPlanError", "all_patterns", "all_plans", "get_plan", "get_plan_config",
           "get_scan_pattern_generator", "parse_scan_kwargs", "parse_time", "validate_pointing_kwargs"]

PLAN_CONFIGS = read_config("plans")
all_plans = sorted(PLAN_CONFIGS)

# kinematic and elevation thresholds (deg/s^2, deg)
MAX_ACCELERATION_WARN = 10
MIN_ELEVATION_WARN = 20
MIN_ELEVATION_ERROR = 10

# the typed fields of a plan's configuration
PLAN_FIELDS = {
    "start_time": (float, str),
    "duration": float,
    "sample_rate": float,
    "frame": str,
    "degrees": bool,
    "scan_center": tuple,
    "scan_pattern": str,
    "scan_options": dict,
}


class UnsupportedPlanError(ValueError):
    def __init__(self, plan_name):
        super().__init__(f"'{plan_name}' is not a supported plan. Supported plans are {all_plans}.")


def get_plan_config(plan_name: str = "ten_second_zenith_stare", **kwargs) -> dict:
    if plan_name not in PLAN_CONFIGS:
        raise UnsupportedPlanError(plan_name)
    return {**PLAN_CONFIGS[plan_name], **kwargs}


def get_plan(plan_name: str = None, **kwargs) -> Plan:
    """The registry's plan ``plan_name`` with keyword overrides; a bare
    pattern name ("daisy", "stare", ...) is ``Plan.generate`` of that
    pattern with the keywords; with no name, the keywords make the plan
    when they name a pattern or a centre, else they override the
    default plan. ``pointing_frame`` is another name for ``frame``."""
    if "pointing_frame" in kwargs:
        kwargs["frame"] = kwargs.pop("pointing_frame")
    if plan_name is None:
        if "scan_pattern" in kwargs or "scan_center" in kwargs:
            return Plan.generate(**kwargs)
        plan_name = "ten_second_zenith_stare"
    if plan_name not in PLAN_CONFIGS and plan_name in SCAN_PATTERNS:
        return Plan.generate(scan_pattern=plan_name, **kwargs)
    return Plan.generate(**get_plan_config(plan_name, **kwargs))


def validate_pointing_kwargs(kwargs: dict):
    """A plan needs an end: one of 'end_time' or 'duration'."""
    if "end_time" not in kwargs and "duration" not in kwargs:
        raise ValueError("One of 'end_time' or 'duration' must be in the plan kwargs.")
