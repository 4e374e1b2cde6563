"""Sky maps (maria_tpu/map): ``ProjectionMap``, ``HEALPixMap``, the named
input maps and map files.

``get`` synthesizes a named map with numpy, seeded by the family's name.
Every family of maria_tpu's is here: ``polarized_source`` in Stokes IQUV
and ``spectral_line_cube`` on a velocity axis among them. The named
products' files ("maps/cluster2.fits", "maps/M1.h5") are made offline by
the generator registered with ``io.fetch``: it writes the synthetic
stand-in in the file's format, as maria_tpu does without a network.
``get(name, fetch_first=True)`` loads that file; the default synthesizes
directly, without a file. ``load`` reads a map from FITS or HDF5 (h5py).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from ..io.caching import register_generator
from .base import SLICE_DIMS, Map, concatenate  # noqa: F401
from .healpix import HEALPixMap  # noqa: F401
from .projection import ProjectionMap  # noqa: F401

__all__ = ["EXAMPLE_MAPS", "HEALPixMap", "MAP_ALIASES", "REFERENCE_MAP_CENTERS", "REFERENCE_MAP_FILES", "SLICE_DIMS",
           "Map", "ProjectionMap", "all_maps", "concatenate", "get", "load", "read_hdf_map"]

# a map's construction keywords, and the FITS axis names and default units
MAP_SIZE_KWARGS = ["xi", "eta", "width", "height", "xi_res", "eta_res", "resolution"]
VALID_MAP_KWARGS = ["stokes", "nu", "t", "center", "frame", "units", "beam", *MAP_SIZE_KWARGS]
AXIS_MAPPING = {
    "nu": {"aliases": ["FREQ", "NU"], "default_units": "Hz"},
    "t": {"aliases": ["TIME"], "default_units": "s"},
    "z": {"aliases": ["REDSHIFT"], "default_units": ""},
    "v": {"aliases": ["VRAD", "VELO"], "default_units": "m/s"},
}

EXAMPLE_MAPS = {
    "cluster": {
        "description": "A beta-model galaxy-cluster decrement at 150 GHz",
        "aliases": ["cluster1", "cluster2", "cluster3"],
        "width": 0.25,
        "n": 256,
        "units": "K_RJ",
        "nu": 150e9,
    },
    "big_cluster": {
        "description": "A large, bright beta-model cluster",
        "width": 0.5,
        "n": 512,
        "units": "K_RJ",
        "nu": 93e9,
    },
    "point_sources": {
        "description": "A field of point sources",
        "width": 0.5,
        "n": 512,
        "units": "K_RJ",
        "nu": 150e9,
    },
    "galaxy": {
        "description": "An inclined exponential-disk galaxy with spiral arms",
        "aliases": ["radio_galaxy", "radio_galaxy_3C_288", "M51HA"],
        "width": 0.2,
        "n": 256,
        "units": "K_RJ",
        "nu": 150e9,
    },
    "dust": {
        "description": "Filamentary galactic dust (power-law random field)",
        "aliases": ["30dor", "monoceros_R2", "orion_A", "crab_nebula", "M1", "maria"],
        "width": 1.0,
        "n": 512,
        "units": "K_RJ",
        "nu": 353e9,
    },
    "quasar": {
        "description": "A bright unresolved quasar",
        "width": 0.1,
        "n": 128,
        "units": "K_RJ",
        "nu": 90e9,
    },
    "spectral_line_cube": {
        "description": "A rotating molecular disk resolved into velocity channels",
        "aliases": ["12CO(2-1)", "circinus_galaxy"],
        "width": 0.2,
        "n": 256,
        "n_v": 16,
        "units": "K_RJ",
        "nu": 230.538e9,
    },
    "polarized_source": {
        "description": "A ~10%-polarized ring/point source with tangential polarization (IQUV)",
        "aliases": ["einstein", "quasar_3C_286", "polarized_quasar"],
        "width": 0.1,
        "n": 256,
        "units": "K_RJ",
        "nu": 150e9,
    },
    "protoplanetary_disk": {
        "description": "An inclined ring system around a point source",
        "width": 0.02,
        "n": 256,
        "units": "K_RJ",
        "nu": 230e9,
    },
    "time_evolving_source": {
        "description": "A flaring point source (3 time frames)",
        "aliases": ["time_evolving_sun"],
        "width": 0.2,
        "n": 128,
        "units": "K_RJ",
        "nu": 100e9,
    },
}

def _edge_taper_weight(shape) -> np.ndarray:
    """Cosine-taper observation weight: highest in the middle, falling
    toward the edges, as real map products' coverage weights do."""
    wy = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(shape[0]) + 0.5) / shape[0])
    wx = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(shape[1]) + 0.5) / shape[1])
    return np.clip(np.sqrt(wy[:, None] * wx[None, :]), 1e-3, None)


def _synthesize_example(name: str, center=(150.0, 10.0), t=None, **overrides) -> ProjectionMap:
    """The synthetic family ``name`` around ``center`` (degrees, ra/dec);
    ``overrides`` replace entries of its EXAMPLE_MAPS configuration (n,
    width, nu, ...). Seeded by the family's name, so every process makes
    the same map, bit for bit the one maria_tpu makes."""
    cfg = {**EXAMPLE_MAPS[name], **overrides}
    n = cfg["n"]
    width_rad = np.radians(cfg["width"])
    x = np.linspace(-width_rad / 2, width_rad / 2, n)
    X, Y = np.meshgrid(x, x)
    rng = np.random.default_rng(zlib.crc32(name.encode()))  # stable across processes

    if "cluster" in name:
        # isothermal beta model, theta_c ~ 1/10 of the map
        theta_c = width_rad / 12
        amp = 1e-4 if name == "cluster" else 5e-4  # K_RJ decrement scale
        data = -amp * (1 + (X**2 + Y**2) / theta_c**2) ** (-1.0)
        # a couple of substructure blobs
        for _ in range(3):
            cx, cy = rng.uniform(-width_rad / 4, width_rad / 4, 2)
            s = width_rad / 40
            data -= 0.3 * amp * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * s**2))
    elif name == "point_sources":
        data = np.zeros((n, n))
        for _ in range(30):
            cx, cy = rng.uniform(-width_rad / 2.2, width_rad / 2.2, 2)
            s = width_rad / n  # ~1 pixel
            amp = 10 ** rng.uniform(-5, -3.3)
            data += amp * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * s**2))
    elif name == "galaxy":
        # inclined exponential disk + two-arm logarithmic spiral
        inc, pa = 0.9, 0.6
        Xr = np.cos(pa) * X + np.sin(pa) * Y
        Yr = (-np.sin(pa) * X + np.cos(pa) * Y) / np.cos(inc)
        r = np.sqrt(Xr**2 + Yr**2)
        phi = np.arctan2(Yr, Xr)
        scale = width_rad / 8
        disk = np.exp(-r / scale)
        arms = 1 + 0.6 * np.cos(2 * (phi - 4.0 * np.log(r / scale + 1e-3)))
        data = 2e-4 * disk * arms
    elif name == "dust":
        # power-law (k^-2.7) Gaussian random field, exponentiated for
        # filamentary positive emission
        k = np.sqrt(
            np.fft.fftfreq(n)[:, None] ** 2 + np.fft.rfftfreq(n)[None, :] ** 2
        )
        with np.errstate(divide="ignore"):
            amp_k = np.where(k > 0, k**-1.35, 0.0)
        white = rng.standard_normal((n, n))
        g = np.fft.irfft2(np.fft.rfft2(white) * amp_k, s=(n, n))
        g = (g - g.mean()) / (g.std() + 1e-30)
        data = 5e-5 * np.exp(0.8 * g)
    elif name == "quasar":
        s = width_rad / n
        data = 3e-3 * np.exp(-(X**2 + Y**2) / (2 * s**2))
    elif name == "spectral_line_cube":
        # rotating inclined disk: each velocity channel lights up where
        # the line-of-sight rotation speed matches the channel
        inc, pa = 0.8, 0.5
        Xr = np.cos(pa) * X + np.sin(pa) * Y
        Yr = (-np.sin(pa) * X + np.cos(pa) * Y) / np.cos(inc)
        r = np.sqrt(Xr**2 + Yr**2) + 1e-12
        scale = width_rad / 8
        disk = np.exp(-r / scale)
        v_max = 200e3  # m/s flat rotation speed
        v_los = v_max * (Xr / r) * np.sin(inc)  # projected rotation
        n_v = cfg.get("n_v", 16)
        v_chan = np.linspace(-1.1 * v_max, 1.1 * v_max, n_v)
        dv = v_chan[1] - v_chan[0]
        data = np.stack(
            [2e-4 * disk * np.exp(-((v_los - vc) ** 2) / (2 * (0.8 * dv) ** 2)) for vc in v_chan]
        )  # (v, y, x)
        w = _edge_taper_weight(data.shape[-2:])
        return ProjectionMap(
            data=data[None, None].astype(np.float32),
            weight=np.broadcast_to(w, (1, 1, n_v, *w.shape)).astype(np.float32).copy(),
            center=center, width=cfg["width"], frame="ra/dec",
            nu=[cfg["nu"]], v=v_chan, units=cfg["units"], degrees=True,
        )
    elif name == "polarized_source":
        # ring + core in I; tangential ~10% linear polarization, V=0
        r = np.sqrt(X**2 + Y**2)
        chi = np.arctan2(Y, X) + np.pi / 2  # tangential polarization angle
        ring = np.exp(-((r - width_rad / 6) ** 2) / (2 * (width_rad / 40) ** 2))
        core = np.exp(-(r**2) / (2 * (width_rad / n) ** 2))
        I = 1e-3 * ring + 3e-3 * core
        p = 0.1 * ring / (ring.max() + 1e-30)
        Q = p * I * np.cos(2 * chi)
        U = p * I * np.sin(2 * chi)
        V = np.zeros_like(I)
        data = np.stack([I, Q, U, V])  # (stokes, y, x)
        w = _edge_taper_weight(I.shape)
        return ProjectionMap(
            data=data[:, None, None].astype(np.float32),
            weight=np.broadcast_to(w, (4, 1, 1, *w.shape)).astype(np.float32).copy(),
            center=center, width=cfg["width"], frame="ra/dec", stokes="IQUV",
            nu=[cfg["nu"]], units=cfg["units"], degrees=True,
        )
    elif name == "protoplanetary_disk":
        inc, pa = 0.7, 1.1
        Xr = np.cos(pa) * X + np.sin(pa) * Y
        Yr = (-np.sin(pa) * X + np.cos(pa) * Y) / np.cos(inc)
        r = np.sqrt(Xr**2 + Yr**2)
        data = 1e-3 * np.exp(-((r - width_rad / 6) ** 2) / (2 * (width_rad / 40) ** 2))
        data += 5e-4 * np.exp(-((r - width_rad / 3) ** 2) / (2 * (width_rad / 30) ** 2))
        data += 2e-3 * np.exp(-(X**2 + Y**2) / (2 * (width_rad / n) ** 2))
    elif name == "time_evolving_source":
        s = width_rad / 30
        frames = []
        for amp in (1e-4, 8e-4, 2e-4):  # quiescent -> flare -> decay
            frames.append(amp * np.exp(-(X**2 + Y**2) / (2 * s**2)))
        data = np.stack(frames)  # (t, y, x)
    else:
        raise KeyError(name)

    if data.ndim == 3:  # time-evolving
        # frame times are absolute unix stamps (the samplers blend by
        # map.t - obs.t[0]); pass t=(t0, t0 + dt, ...) to align with a plan
        if t is None:
            t = 1.75e9 + np.array([0.0, 300.0, 600.0])
        w = _edge_taper_weight(data.shape[-2:])
        return ProjectionMap(
            data=data[None, None].astype(np.float32),
            weight=np.broadcast_to(w, (1, 1, data.shape[0], *w.shape)).astype(np.float32).copy(),
            center=center, width=cfg["width"], frame="ra/dec",
            nu=[cfg["nu"]], t=np.asarray(t, dtype=np.float64), units=cfg["units"], degrees=True,
        )

    w = _edge_taper_weight(data.shape[-2:])
    return ProjectionMap(
        data=data[None, None, None].astype(np.float32),
        weight=w[None, None, None].astype(np.float32),
        center=center,
        width=cfg["width"],
        frame="ra/dec",
        nu=[cfg["nu"]],
        units=cfg["units"],
        degrees=True,
    )


MAP_ALIASES = {
    alias: key for key, cfg in EXAMPLE_MAPS.items() for alias in cfg.get("aliases", [])
}

# canonical sky centres (deg, ra/dec) of the named products whose
# stand-ins are synthesized here, so that the documented Planner
# constraints (site and elevation windows) stay feasible: M1, for one,
# must rise above 60 deg at Green Bank
REFERENCE_MAP_CENTERS = {
    "M1": (83.63, 22.01), "crab_nebula": (83.63, 22.01),
    "30dor": (84.68, -69.10),
    "orion_A": (83.82, -5.39),
    "monoceros_R2": (161.0, -7.6),
    "M51HA": (202.47, 47.20),
    "circinus_galaxy": (213.29, -65.34),
    "radio_galaxy_3C_288": (206.18, 38.85),
    "quasar_3C_286": (202.78, 30.51),
    "polarized_quasar": (202.78, 30.51),
    "einstein": (339.49, 3.36),
    "12CO(2-1)": (83.82, -5.39),
    "protoplanetary_disk": (165.46, -34.70),
    "cluster": (150.0, -30.0), "cluster1": (150.0, -30.0),
    "cluster2": (150.5, -29.5), "cluster3": (149.5, -30.5),
    "big_cluster": (150.0, -30.0),
}


# the named products' files (maria_tpu/map/maps.txt), made offline by
# ``_generate_map_file``
REFERENCE_MAP_FILES = {
    "12CO(2-1)": "maps/12CO(2-1).fits",
    "30dor": "maps/30dor.fits",
    "M1": "maps/M1.h5",
    "M51HA": "maps/M51HA.fits",
    "circinus_galaxy": "maps/circinus_galaxy.h5",
    "cluster": "maps/cluster1.fits",
    "cluster1": "maps/cluster1.fits",
    "cluster2": "maps/cluster2.fits",
    "cluster3": "maps/cluster3.fits",
    "crab_nebula": "maps/crab_nebula.fits",
    "dust": "maps/dust.fits",
    "einstein": "maps/einstein.h5",
    "maria": "maps/maria.h5",
    "monoceros_R2": "maps/monoceros_R2.h5",
    "orion_A": "maps/orion_A.h5",
    "protoplanetary_disk": "maps/protoplanetary_disk.fits",
    "quasar": "maps/quasar_3C_286.h5",
    "quasar_3C_286": "maps/quasar_3C_286.h5",
    "radio_galaxy_3C_288": "maps/radio_galaxy_3C_288.fits",
    "time_evolving_source": "maps/time_evolving_sun.fits",
    "time_evolving_sun": "maps/time_evolving_sun.fits",
}
all_maps = sorted(set(REFERENCE_MAP_FILES.values()))


def _generate_map_file(source_path: str, destination: str):
    """Write the synthetic stand-in of the product ``source_path`` to
    ``destination`` in the format its extension names."""
    stem = os.path.splitext(os.path.basename(source_path))[0]
    name = "time_evolving_sun" if stem == "sun" else stem
    family = MAP_ALIASES.get(name, name)
    if family not in EXAMPLE_MAPS:
        raise FileNotFoundError(f"No synthetic family for map product '{source_path}'.")
    kwargs = {"center": REFERENCE_MAP_CENTERS[name]} if name in REFERENCE_MAP_CENTERS else {}
    m = _synthesize_example(family, **kwargs)
    if destination.endswith((".h5", ".hdf5")):
        m.to_hdf(destination)
    else:
        m.to_fits(destination)


register_generator("maps/", _generate_map_file)


def __getattr__(name):
    if name == "cmb_cmap":  # maria_tpu.map.cmb_cmap, made when asked (needs matplotlib)
        from ..plotting.map import cmb_cmap

        return cmb_cmap
    raise AttributeError(name)


def get(name: str, fetch_first: bool = False, **kwargs) -> ProjectionMap:
    """The named input map: a family of EXAMPLE_MAPS, one of its
    aliases, or the path form of either ("maps/M1.h5"). ``kwargs`` go to
    the generator: center (degrees), t, and overrides of the family's
    configuration. With ``fetch_first`` a named product is loaded from its
    file in the cache (``io.fetch`` makes it), ``kwargs`` but n
    overriding the file's metadata, as maria_tpu's ``get`` does."""
    stem = os.path.splitext(os.path.basename(name))[0]
    if name not in EXAMPLE_MAPS and name not in MAP_ALIASES and (stem in EXAMPLE_MAPS or stem in MAP_ALIASES):
        name = stem
    if name == "sun":  # "maps/sun.h5" is the time-evolving sun
        name = "time_evolving_sun"
    if fetch_first and name in REFERENCE_MAP_FILES:
        from ..io.caching import fetch

        return load(fetch(REFERENCE_MAP_FILES[name]), **{k: v for k, v in kwargs.items() if k != "n"})
    family = MAP_ALIASES.get(name, name)
    if family not in EXAMPLE_MAPS:
        if os.path.exists(name):
            return load(name, **kwargs)
        raise ValueError(f"'{name}' is not a known map (known: {sorted({*EXAMPLE_MAPS, *MAP_ALIASES})}).")
    if name in REFERENCE_MAP_CENTERS:
        kwargs.setdefault("center", REFERENCE_MAP_CENTERS[name])
    return _synthesize_example(family, **kwargs)


def load(path: str = None, filename: str = None, **kwargs) -> Map:
    """The map in a FITS (``io.fits.read_fits_map``) or HDF5 file
    (``read_hdf_map``), on the host; ``filename`` is another name for
    ``path``, and keywords override the file's metadata."""
    path = path if path is not None else filename
    if path.endswith((".h5", ".hdf5")):
        return read_hdf_map(path, **kwargs)
    if path.endswith((".fits", ".fits.gz")):
        from ..io.fits import read_fits_map

        return read_fits_map(path, **kwargs)
    raise ValueError(f"Cannot infer map format from '{path}'.")


def read_hdf_map(path: str, **overrides) -> Map:
    """The map of an HDF5 file in maria_tpu's layout (needs h5py): a
    ProjectionMap where the file gives a resolution, else a HEALPixMap;
    ``overrides`` replace what the file gives (width or height replaces
    its resolution)."""
    import h5py

    with h5py.File(path, "r") as f:
        data = f["data"][:]
        attrs = dict(f.attrs)
        nu = f["nu"][:] if "nu" in f else None
        t = f["t"][:] if "t" in f else None
        weight = f["weight"][:] if "weight" in f else None
    axis3 = {str(attrs.get("axis3_label", "t")): t}
    if "resolution_deg" in attrs:
        kw = dict(data=data, weight=weight, center=attrs["center_deg"], resolution=attrs["resolution_deg"],
                  frame=attrs.get("frame", "ra/dec"), stokes=attrs.get("stokes"), nu=nu,
                  units=attrs.get("units", "K_RJ"), degrees=True, **axis3)
        if "width" in overrides or "height" in overrides:
            kw.pop("resolution")
        kw.update(overrides)
        return ProjectionMap(**kw)
    kw = dict(data=data, frame=attrs.get("frame", "galactic"), stokes=attrs.get("stokes"), nu=nu,
              units=attrs.get("units", "K_CMB"), weight=weight, **axis3)
    kw.update(overrides)
    return HEALPixMap(**kw)
