"""The scenes that chip_smoke.py and the profilers (``profile_slice``,
``profile_bin``) drive, built through the user's entry points.

"mustang2": MUSTANG-2 at the GBT with the 2-D atmosphere (bench.py's
MUSTANG-2 scene at 60 s; the README's flow at 600 s); "atlast":
AtLAST-50k at ALMA with the 3-D atmosphere (bench.py's ``config_b``).
Both scan the daisy at (150, 41) deg in az/el at 50 Hz, with noise, seed
0, and take the atmosphere's ``method``: "fourier" (the default) or "ar"
(the autoregressive extrusion, ``atmosphere_kwargs={"method": "ar"}``).
"""

from __future__ import annotations

SCENES = {
    "mustang2": dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", radius=0.083, speed=0.017),
    "atlast": dict(instrument="AtLAST-50k", site="ALMA", atmosphere="3d", radius=0.5, speed=0.25),
}


def simulation(scene: str, duration: float, device=None, method: str = "fourier"):
    """The ``Simulation`` of ``scene`` (a key of SCENES) for ``duration``
    seconds on ``device``, with the atmosphere's ``method``."""
    import maria_torch

    s = SCENES[scene]
    plan = maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=duration,
        sample_rate=50.0, scan_options={"radius": s["radius"], "speed": s["speed"]},
    )
    return maria_torch.Simulation(instrument=s["instrument"], plans=plan, site=s["site"], atmosphere=s["atmosphere"],
                                  atmosphere_kwargs={"method": method}, noise=True, seed=0, device=device)
