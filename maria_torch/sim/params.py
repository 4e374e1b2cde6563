"""The loose keywords of ``Simulation`` (maria_tpu/sim/params.py): each
master parameter is routed to its subsystem's keywords; an unknown key
raises ``InvalidSimulationParameterError``."""

from __future__ import annotations

from ..errors import InvalidSimulationParameterError

__all__ = ["MASTER_PARAMS", "master_params", "parse_sim_kwargs"]

MASTER_PARAMS = {
    "atmosphere": [
        "model", "region", "altitude", "weather", "weather_quantiles",
        "weather_source", "spectrum_source", "pwv_rms_frac", "pwv",
        "max_height", "min_height", "timestep", "method", "n_layers", "outer_scale",
        "sampler_dec_tol",
    ],
    "cmb": ["nside", "lmax"],
    "map": ["nu", "units", "bilinear_sampling"],
    "noise": ["correlated_noise_proportion", "correlated_noise_spatial_scale"],
}


def parse_sim_kwargs(kwargs: dict, strict: bool = True) -> dict:
    """{subsystem: {key: value}} of the loose ``kwargs``; with ``strict``
    an unknown key raises."""
    parsed = {group: {} for group in MASTER_PARAMS}
    invalid = {}
    for key, value in kwargs.items():
        matched = False
        for group, valid_keys in MASTER_PARAMS.items():
            if key in valid_keys:
                parsed[group][key] = value
                matched = True
        if not matched:
            invalid[key] = value
    if invalid and strict:
        raise InvalidSimulationParameterError(list(invalid))
    return parsed


# maria_tpu's alias of the same table
master_params = MASTER_PARAMS
