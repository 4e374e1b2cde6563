"""Build a deployment's ``maria_torch.Simulation`` from its configuration
file (``configs/<config>.json``) and a traffic mix's duration.

A configuration states its array (with every band's passband and
noise), the site, the scan plan, the sky and the noise, frozen in the
file; this module turns it into the user's calls:
``get_instrument(array=...)`` with the bands made from their
parameters, ``Site``, ``Plan.generate`` and ``Simulation``. It reads
none of the program's registries of instruments, bands, sites or
plans, nor ``maria_torch.scenes``: the scene is fixed by the file, not
by the program.
"""

from __future__ import annotations


def instrument(config: dict):
    """The configuration's instrument."""
    import maria_torch
    from maria_torch.band import Band

    array = dict(config["array"])
    bands = [Band(**spec) for spec in array.pop("bands")]
    return maria_torch.get_instrument(array={**array, "bands": bands})


def site(config: dict):
    """The configuration's site: its weather region and its location."""
    from maria_torch.site import Site

    return Site(**config["site"])


def plan(config: dict, duration: float):
    """The configuration's plan at its site, ``duration`` seconds long."""
    import maria_torch

    return maria_torch.Plan.generate(duration=duration, site=site(config), **config["plan"])


def simulation(config: dict, duration: float, seed: int, device):
    """The Simulation of the configuration at ``duration`` seconds, its
    draws (and a generated CMB) seeded with ``seed``, on ``device``."""
    import maria_torch

    sky = config.get("sky", {})
    return maria_torch.Simulation(
        instrument(config), plans=[plan(config, duration)], site=site(config),
        atmosphere=sky.get("atmosphere"), atmosphere_kwargs=sky.get("atmosphere_kwargs", {}),
        cmb=sky.get("cmb"), cmb_kwargs=sky.get("cmb_kwargs", {}), noise=config.get("noise", True),
        noise_kwargs=config.get("noise_kwargs", {}), seed=seed, device=device,
    )
