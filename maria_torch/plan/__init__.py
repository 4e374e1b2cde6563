"""Scan plans (maria_tpu/plan): ``Plan`` and ``PlanList``, the named
plans of the registry, and the constraint-based ``Planner``."""

from __future__ import annotations

from ..io import read_config
from .plan import Plan, PlanList, daisy, parse_time  # noqa: F401
from .planner import NoSuitablePlansError, Planner  # noqa: F401

__all__ = ["NoSuitablePlansError", "Plan", "PlanList", "Planner", "daisy", "get_plan", "parse_time"]


def get_plan(plan_name: str, **kwargs) -> Plan:
    plans = read_config("plans")
    if plan_name not in plans:
        raise NotImplementedError(f"plan '{plan_name}' (ROADMAP queue 1, item 13); supported: {sorted(plans)}")
    return Plan.generate(**{**plans[plan_name], **kwargs})
