"""Scan plans (maria_tpu/plan): ``Plan`` and ``PlanList``, the scan
patterns, the six named plans of the registry, and the constraint-based
``Planner``."""

from __future__ import annotations

from ..io import read_config
from .patterns import SCAN_PATTERNS, all_patterns, get_scan_pattern_generator, parse_scan_kwargs  # noqa: F401
from .plan import Plan, PlanList, parse_time  # noqa: F401
from .planner import NoSuitablePlansError, Planner  # noqa: F401

__all__ = ["NoSuitablePlansError", "PLAN_CONFIGS", "Plan", "PlanList", "Planner", "SCAN_PATTERNS", "all_patterns",
           "all_plans", "get_plan", "get_plan_config", "get_scan_pattern_generator", "parse_scan_kwargs",
           "parse_time"]

PLAN_CONFIGS = read_config("plans")
all_plans = sorted(PLAN_CONFIGS)


def get_plan_config(plan_name: str = "ten_second_zenith_stare", **kwargs) -> dict:
    if plan_name not in PLAN_CONFIGS:
        raise ValueError(f"'{plan_name}' is not a supported plan; supported: {all_plans}")
    return {**PLAN_CONFIGS[plan_name], **kwargs}


def get_plan(plan_name: str, **kwargs) -> Plan:
    """The registry's plan ``plan_name`` with keyword overrides."""
    return Plan.generate(**get_plan_config(plan_name, **kwargs))
