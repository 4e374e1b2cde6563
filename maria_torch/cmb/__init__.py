"""CMB skies (maria_tpu/cmb/__init__.py).

``generate_cmb`` draws a polarized IQU realization of the embedded ΛCDM
spectra on the device (``synalm_cmb_device``) and synthesizes it there:
T by kernel KS1's scalar transform, Q and U by its spin-2 transform, in
K_CMB, galactic frame, at 150 GHz. ``generate_cmb_patch`` is the
flat-sky FFT realization of the TT spectrum, in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..healpix.sht import alm2map, alm2map_spin, synalm_cmb_device
from ..map.healpix import HEALPixMap
from ..map.projection import ProjectionMap
from .spectra import get_cmb_spectrum

__all__ = ["CMB", "generate_cmb", "generate_cmb_patch", "get_cmb", "get_cmb_spectrum"]

# maria_tpu's sources of a real CMB: downloads, which the port does not make
CMB_SPECTRUM_SOURCE_URL = (
    "https://github.com/thomaswmorris/maria-data/raw/master/cmb/spectra/"
    "COM_PowerSpect_CMB-base-plikHM-TTTEEE-lowl-lowE-lensing-minimum-theory_R3.01.txt"
)
CMB_SOURCES = {"planck": {"spectrum": "cmb/spectra/planck.csv"}}


class CMB(HEALPixMap):
    """An IQU CMB sky in K_CMB, galactic frame."""


def generate_cmb(nside: int = 256, lmax: int = None, seed: int = None, device=None) -> CMB:
    """A polarized IQU CMB realization of the TT/EE/BB/TE spectra:
    (aT, aE, aB) drawn on ``device`` from a torch generator seeded with
    ``seed`` (0 when None), T by the scalar transform and Q/U by the
    spin-2 transform. ``lmax`` defaults to min(3 nside - 1, 2500). The
    draws are torch's: the same seed gives another realization than
    maria_tpu's jax.random draw, of the same spectra."""
    device = resolve_device(device)
    lmax = lmax if lmax is not None else min(3 * nside - 1, 2500)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) if seed is not None else 0)
    aT, aE, aB = synalm_cmb_device(get_cmb_spectrum(lmax=lmax), lmax=lmax, generator=generator)
    T = alm2map(aT, nside)
    Q, U = alm2map_spin(aE, aB, nside)
    return CMB(data=torch.stack([T, Q, U])[:, None, None], stokes="IQU", units="K_CMB", frame="galactic",
               nu=[150e9])


def get_cmb(device=None) -> CMB:
    """The offline stand-in of the observed (Planck SMICA) CMB sky that
    maria_tpu's fetch chain falls back to: a seed-777 realization at
    nside 256, labelled 143 GHz, synthesized directly (no file is written
    or read). Its draws are torch's, so it is another realization of the
    same spectra than maria_tpu's stand-in. Fetching and reading the real
    map are not ported."""
    return generate_cmb(nside=256, seed=777, device=device)._replace(nu=[143e9])


def generate_cmb_patch(
    width: float = 5.0,  # degrees
    resolution: float = None,  # degrees
    center=(0.0, 0.0),  # degrees
    frame: str = "ra/dec",
    nu: float = 150e9,
    seed: int = None,
    pad_factor: float = 1.5,
) -> ProjectionMap:
    """Flat-sky FFT realization of the TT spectrum, in K_CMB; host numpy,
    bit for bit maria_tpu's for the same seed."""
    resolution = resolution if resolution is not None else width / 512
    n = int(round(width / resolution))
    n_pad = int(n * pad_factor)

    res_rad = np.radians(resolution)
    kx = 2 * np.pi * np.fft.fftfreq(n_pad, d=res_rad)
    ky = 2 * np.pi * np.fft.rfftfreq(n_pad, d=res_rad)
    ell = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)

    spectra = get_cmb_spectrum(lmax=int(min(ell.max() + 2, 20000)))
    cl = np.interp(ell, spectra["ell"], spectra["TT"])
    W = np.sqrt(np.clip(cl, 0, None) / res_rad**2)

    rng = np.random.default_rng(seed)
    white = rng.standard_normal((n_pad, n_pad))
    field = np.fft.irfft2(np.fft.rfft2(white)[:, : len(ky)] * W, s=(n_pad, n_pad))

    lo = (n_pad - n) // 2
    patch = field[lo : lo + n, lo : lo + n].astype(np.float32)
    return ProjectionMap(data=patch[None, None, None], center=center, width=width, frame=frame, nu=[nu],
                         units="K_CMB", degrees=True)
