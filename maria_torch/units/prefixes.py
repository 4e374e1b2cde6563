"""SI prefixes (maria_tpu/units/prefixes.py)."""

from __future__ import annotations

import numpy as np

# name -> (symbol, factor)
PREFIXES = {
    "quecto": ("q", 1e-30),
    "ronto": ("r", 1e-27),
    "yocto": ("y", 1e-24),
    "zepto": ("z", 1e-21),
    "atto": ("a", 1e-18),
    "femto": ("f", 1e-15),
    "pico": ("p", 1e-12),
    "nano": ("n", 1e-9),
    "micro": ("u", 1e-6),
    "milli": ("m", 1e-3),
    "centi": ("c", 1e-2),
    "deci": ("d", 1e-1),
    "": ("", 1e0),
    "deca": ("da", 1e1),
    "hecto": ("h", 1e2),
    "kilo": ("k", 1e3),
    "mega": ("M", 1e6),
    "giga": ("G", 1e9),
    "tera": ("T", 1e12),
    "peta": ("P", 1e15),
    "exa": ("E", 1e18),
    "zetta": ("Z", 1e21),
    "yotta": ("Y", 1e24),
    "ronna": ("R", 1e27),
    "quetta": ("Q", 1e30),
}

SYMBOL_TO_FACTOR = {symbol: factor for _, (symbol, factor) in PREFIXES.items()}

# prefixes used when "humanizing" a value (powers of 1000 only)
PRIMARY_SYMBOLS = [
    ("q", 1e-30), ("r", 1e-27), ("y", 1e-24), ("z", 1e-21), ("a", 1e-18),
    ("f", 1e-15), ("p", 1e-12), ("n", 1e-9), ("u", 1e-6), ("m", 1e-3),
    ("", 1e0), ("k", 1e3), ("M", 1e6), ("G", 1e9), ("T", 1e12),
    ("P", 1e15), ("E", 1e18), ("Z", 1e21), ("Y", 1e24),
]


def best_prefix(value: float):
    """Pick the SI prefix that puts |value| in [1, 1000)."""
    if not np.isfinite(value) or value == 0:
        return "", 1e0
    mag = abs(float(value))
    for symbol, factor in reversed(PRIMARY_SYMBOLS):
        if mag >= factor:
            return symbol, factor
    return PRIMARY_SYMBOLS[0][:2]
