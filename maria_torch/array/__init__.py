"""Detector arrays (maria_tpu/array): per-detector focal-plane offsets,
polarization angles, band assignment, apertures and baselines, held as
numpy columns where maria_tpu holds a pandas table.

``Array.from_config`` takes maria_tpu's keywords and builds the same
table in the same order: a pattern (``generation.generate_2d_pattern``)
or explicit offsets or baselines; ``polarized: true`` doubles every
position into an "A" detector at a random gamma and a "B" at gamma +
pi/2, the gammas drawn from a generator seeded by the array's name (so an
array is named as maria_tpu names it: its registry key, ``array-{i}`` in
an ``Instrument``, "array" from ``get_instrument(array=...)``, else a
random uuid); every position is copied once a band; and the rows are
sorted stably by (band_name, base_det_index).
"""

from __future__ import annotations

import csv
import os
import uuid

import numpy as np
import scipy as sp
import torch

from ..band import BandList, parse_band
from ..constants import c as speed_of_light
from ..io import flatten_config, read_config
from ..utils import compute_diameter
from .generation import PACKINGS, SHAPES, generate_2d_pattern  # noqa: F401
from .rows import band_rows, device_rows

__all__ = ["ARRAY_CONFIGS", "Array", "ArrayList", "all_arrays", "compute_angular_fwhm",
           "generate_2d_pattern", "get_array", "get_array_config"]

HERE = os.path.dirname(os.path.abspath(__file__))

# configs/array_<tag>.json holds maria_tpu/array/configs/<tag>.yml
ARRAY_TAGS = ("act", "alma", "apex", "hd", "m2", "so")
ARRAY_CONFIGS = flatten_config({tag: read_config(f"array_{tag}") for tag in ARRAY_TAGS})
all_arrays = sorted(ARRAY_CONFIGS)

# the type of every detector column, the keywords that may be given per
# detector, and every keyword of an array's configuration (maria_tpu's tables)
DET_COLUMN_TYPES = {
    "array_name": str, "uid": str, "base_det_index": int, "band_name": str,
    "band_center": float, "xi": float, "eta": float,
    "baseline_x": float, "baseline_y": float, "baseline_z": float,
    "gamma": float, "pol_label": str, "primary_size": float,
    "bath_temp": float, "time_constant": float, "efficiency": float,
}
PER_DET_KWARGS = ["xi", "eta", "baseline_x", "baseline_y", "baseline_z", "gamma", "pol_label", "band"]
ALLOWED_ARRAY_KWARGS = [
    "band", "bands", "max_baseline", "baseline_offset", "beam_spacing",
    "field_of_view", "focal_plane_offset", "n", "array_offset", "packing",
    "polarization", "primary_size", "shape", "bath_temp", "file", *PER_DET_KWARGS,
]

def compute_angular_fwhm(fwhm_0, z=np.inf, n=1.0, nu=None, l=None):  # noqa: E741
    """Angular FWHM of a Gaussian beam from an aperture of diameter
    ``fwhm_0`` at distance z (maria_tpu/beam), at the frequency ``nu`` in
    Hz or the wavelength ``l`` in metres."""
    if nu is None and l is None:
        raise ValueError("You must supply either a frequency 'nu' or wavelength 'l'.")
    w_0 = fwhm_0 / 2
    z_r = np.pi * w_0**2 * n / (l if l is not None else speed_of_light / nu)
    z = np.asarray(z, dtype=float)
    with np.errstate(divide="ignore"):
        inv_z = np.where(np.isinf(z), 0.0, 1.0 / np.where(np.isinf(z), 1.0, z))
    return 2 * w_0 * np.sqrt(inv_z**2 + 1 / z_r**2)


def _read_table(path: str) -> dict:
    """The columns of a CSV detector table, numeric ones as float arrays."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    columns = {}
    for name in rows[0] if rows else []:
        values = [row[name] for row in rows]
        try:
            columns[name] = np.asarray(values, dtype=float)
        except ValueError:
            columns[name] = np.asarray(values, dtype=object)
    return columns


def _concat(tables: list) -> dict:
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


class Array:
    def __init__(self, name: str, dets: dict, bands):
        self.name = name
        n = len(dets["xi"])
        self.dets = {k: np.asarray(v) for k, v in dets.items()}
        self.dets["array_name"] = np.full(n, name, dtype=object)
        present = set(self.dets["band_name"])
        self.bands = BandList([b for b in bands if b.name in present])
        self._rows = None  # (the band_name column read, its band_rows, {device: band_rows_on})

    # -- construction ------------------------------------------------------------------------

    @classmethod
    def from_kwargs(cls, **kwargs) -> "Array":
        """``from_config`` of the keywords."""
        return cls.from_config(kwargs)

    @classmethod
    def from_config(cls, config: dict) -> "Array":
        c = dict(config)
        degrees = c.pop("degrees", True)
        name = c.pop("name", str(uuid.uuid4())[:8])
        c.pop("description", None)
        for alias, canonical in (("sky_x", "xi"), ("sky_y", "eta"), ("pol_angle", "gamma")):
            if alias in c:
                c.setdefault(canonical, c.pop(alias))

        # a CSV detector table: its columns become per-detector keywords;
        # the path resolves against the package's array directory first
        if "file" in c:
            file = c.pop("file")
            packaged = os.path.join(HERE, file)
            for col, values in _read_table(packaged if os.path.exists(packaged) else file).items():
                if col not in ("pad", "det_index") and not col.startswith("Unnamed"):
                    c.setdefault(col, values)

        bands = BandList([parse_band(b) for b in c.pop("bands")]) if "bands" in c else None
        if bands is None and "band" in c:
            bands = BandList([parse_band(c.pop("band"))])
        if bands is None:
            raise ValueError("Missing array parameter 'bands'.")
        primary_size = c.pop("primary_size", None)
        if primary_size is None:
            raise ValueError("Missing array parameter 'primary_size'.")

        if degrees:
            for param in ("xi", "eta", "field_of_view", "gamma", "rotation"):
                if param in c:
                    c[param] = np.radians(np.asarray(c[param], dtype=float))

        baselines = {k: np.atleast_1d(np.asarray(c.pop(k), dtype=float))
                     for k in ("baseline_x", "baseline_y", "baseline_z") if k in c}
        # an explicit band a detector: detectors are not copied per band
        det_band_names = c.pop("band_name", None)
        if det_band_names is not None:
            det_band_names = np.atleast_1d(np.asarray(det_band_names, dtype=object))
            unknown = set(det_band_names) - set(bands.names)
            if unknown:
                raise ValueError(f"band_name values {sorted(unknown)} are not in bands {bands.names}.")
            n_given = (len(np.atleast_1d(c["xi"])) if "xi" in c
                       else len(next(iter(baselines.values()))) if baselines else None)
            if n_given is not None and len(det_band_names) != n_given:
                raise ValueError(f"band_name has {len(det_band_names)} entries for {n_given} detectors.")

        if "xi" in c and "eta" in c:
            offsets = np.stack([np.atleast_1d(c.pop("xi")), np.atleast_1d(c.pop("eta"))], axis=-1)
        elif baselines:
            # co-pointed antennas (interferometer pads): zero offsets
            offsets = np.zeros((len(next(iter(baselines.values()))), 2))
        else:
            max_resolution = max(compute_angular_fwhm(primary_size, z=np.inf, nu=band.center) for band in bands)
            pattern = {}
            if c.get("n") is not None:
                pattern["n"] = int(c.pop("n"))
                if pattern["n"] == 1:
                    pattern["spacing"] = 0.0
            if "field_of_view" in c:
                pattern["max_diameter"] = float(c.pop("field_of_view"))
            if "beam_spacing" in c and ("max_diameter" in pattern) != ("n" in pattern):
                pattern["spacing"] = float(c.pop("beam_spacing")) * max_resolution
            else:
                c.pop("beam_spacing", None)
            if "n" not in pattern and "spacing" not in pattern:
                pattern["spacing"] = 1.5 * max_resolution
            offsets = generate_2d_pattern(**pattern, shape=c.pop("shape", "hexagon"),
                                          packing=c.pop("packing", "triangular"),
                                          rotation=float(c.pop("rotation", 0.0)))

        n = len(offsets)
        fpo = c.pop("focal_plane_offset", (0.0, 0.0))
        dets = {
            "base_det_index": np.arange(n),
            "xi": offsets[:, 0] + np.radians(fpo[0]),
            "eta": offsets[:, 1] + np.radians(fpo[1]),
            "baseline_x": baselines.get("baseline_x", np.zeros(n)),
            "baseline_y": baselines.get("baseline_y", np.zeros(n)),
            "baseline_z": baselines.get("baseline_z", np.zeros(n)),
            "primary_size": float(np.mean(primary_size)) * np.ones(n),
            "bath_temp": float(c.pop("bath_temp", 0.0)) * np.ones(n),
        }

        # polarization doubles the detectors with orthogonal gammas
        if "gamma" in c:
            dets["gamma"] = np.broadcast_to(np.asarray(c.pop("gamma"), dtype=float), (n,)).copy()
            dets["pol_label"] = np.full(n, "A", dtype=object)
        elif c.pop("polarized", False):
            rng = np.random.default_rng(int.from_bytes(name.encode()[:4].ljust(4, b"x"), "little"))
            gamma = rng.uniform(0, np.pi, size=n)
            dets["gamma"] = gamma
            dets["pol_label"] = np.full(n, "A", dtype=object)
            other = dict(dets, gamma=(gamma + np.pi / 2) % np.pi, pol_label=np.full(n, "B", dtype=object))
            dets = _concat([dets, other])
        else:
            dets["gamma"] = np.full(n, np.nan)
            dets["pol_label"] = np.full(n, "none", dtype=object)

        if det_band_names is not None:
            m = len(dets["xi"])
            dets["band_name"] = np.tile(det_band_names, m // len(det_band_names))
            tc = {b.name: b.time_constant for b in bands}
            dets["time_constant"] = np.array([tc[b] for b in dets["band_name"]], dtype=float)
        else:
            m = len(dets["xi"])
            dets = _concat([dict(dets, band_name=np.full(m, band.name, dtype=object),
                                 time_constant=np.full(m, float(band.time_constant))) for band in bands])
        # stable sort by (band_name, base_det_index): A before B at one position
        _, band_code = np.unique(dets["band_name"].astype(str), return_inverse=True)
        order = np.lexsort((dets["base_det_index"], band_code))
        return cls(name=name, dets={k: v[order] for k, v in dets.items()}, bands=bands)

    # -- structure -----------------------------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.dets["xi"])

    def __len__(self):
        return self.n

    def __getattr__(self, attr):
        dets = self.__dict__.get("dets")
        if dets is not None and attr in dets:
            return dets[attr]
        raise AttributeError(attr)

    def take(self, idx) -> "Array":
        """The rows ``idx`` in their order (duplicates kept)."""
        idx = np.atleast_1d(idx)
        return Array(self.name, {k: v[idx] for k, v in self.dets.items()}, self.bands)

    def subset(self, mask) -> "Array":
        return self.take(np.where(np.asarray(mask))[0])

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.mask(band_name=key)
        return self.take(key)

    def mask(self, **kwargs) -> np.ndarray:
        mask = np.ones(self.n, dtype=bool)
        for key, value in kwargs.items():
            mask &= self.dets[key] == value
        return mask

    def band_rows(self) -> tuple:
        """Each band's rows in ``bands`` order (``rows.band_rows``), built
        once; a ``band_name`` column assigned anew rebuilds them."""
        column = self.dets["band_name"]
        if self._rows is None or self._rows[0] is not column:
            self._rows = (column, band_rows(column, self.bands), {})
        return self._rows[1]

    def band_rows_on(self, device) -> tuple:
        """``band_rows`` as indexers on ``device`` (``rows.device_rows``), built once a device."""
        rows = self.band_rows()
        on, device = self._rows[2], torch.device(device)
        if device not in on:
            on[device] = tuple(device_rows(r, device) for r in rows)
        return on[device]

    def one_detector_from_each_band(self) -> "Array":
        return self.take([int(r[0]) for r in self.band_rows()])

    def outer(self) -> "Array":
        """The detectors on the convex hull of the focal plane."""
        if self.n < 4 or compute_diameter(self.offsets) == 0:
            return self
        return self.take(sp.spatial.ConvexHull(self.offsets).vertices)

    # -- physics -------------------------------------------------------------------------------

    @property
    def offsets(self) -> np.ndarray:
        return np.stack([self.dets["xi"], self.dets["eta"]], axis=-1)

    @property
    def field_of_view(self) -> float:
        """Diameter of the focal plane, in radians."""
        return compute_diameter(self.offsets)

    @property
    def max_baseline(self) -> float:
        """The largest distance between two apertures, in metres."""
        return compute_diameter(np.stack([self.baseline_x, self.baseline_y, self.baseline_z], axis=-1))

    def _per_det_band_attr(self, attr: str) -> np.ndarray:
        values = np.zeros(self.n)
        for band, rows in zip(self.bands, self.band_rows()):
            values[rows] = getattr(band, attr)
        return values

    @property
    def band_center(self) -> np.ndarray:
        return self._per_det_band_attr("center")

    @property
    def gain_error(self) -> np.ndarray:
        return self._per_det_band_attr("gain_error")

    @property
    def knee(self) -> np.ndarray:
        return self._per_det_band_attr("knee")

    @property
    def efficiency(self) -> np.ndarray:
        return self._per_det_band_attr("efficiency")

    def passband(self, nu) -> np.ndarray:
        nu = np.atleast_1d(nu)
        out = np.zeros((self.n, len(nu)))
        for band, rows in zip(self.bands, self.band_rows()):
            out[rows] = band.passband(nu)
        return out

    def mueller(self) -> np.ndarray:
        """Per-detector Mueller matrices from gamma; NaN gamma = unpolarized."""
        a = self.gamma
        m = np.stack(
            [
                np.where(np.isnan(a), np.sqrt(2), 1),
                np.where(np.isnan(a), 0, np.cos(2 * a)),
                np.where(np.isnan(a), 0, np.sin(2 * a)),
                np.zeros_like(a),
            ],
            axis=1,
        )
        return 0.5 * m[..., None] * m[..., None, :]

    def stokes_weight(self) -> np.ndarray:
        """(n_det, 4) weights of I, Q, U, V: (1, 0, 0, 0) unpolarized,
        (1, cos 2 gamma, sin 2 gamma, 0) / 2 polarized."""
        return self.mueller()[:, 0]

    def angular_fwhm(self, z=np.inf) -> np.ndarray:
        """Beam FWHM in radians at distance z."""
        return compute_angular_fwhm(fwhm_0=self.primary_size, z=z, n=1, nu=self.band_center)

    def physical_fwhm(self, z) -> np.ndarray:
        """Beam FWHM in meters at distance z."""
        return np.asarray(z) * self.angular_fwhm(z)

    def plot(self, ax=None):
        """The focal plane's offsets in degrees, a colour a band, each
        marker sized by the band's beam (matplotlib, imported here)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(1, 1, figsize=(5, 5))
        for band, mask in zip(self.bands, self.band_rows()):
            fwhm = np.degrees(np.nanmean(self.angular_fwhm(np.inf)[mask]))
            offsets = np.degrees(self.offsets[mask])
            ax.scatter(offsets[:, 0], offsets[:, 1], s=max(fwhm * 100, 4), label=band.name, alpha=0.6)
        ax.set_xlabel(r"$\xi$ [deg]")
        ax.set_ylabel(r"$\eta$ [deg]")
        ax.set_aspect("equal")
        ax.legend(fontsize=7)
        return ax

    def __repr__(self):
        return f"Array({self.name}: n={self.n}, bands={self.bands.names})"


class ArrayList:
    """Several arrays, combined into one detector table."""

    def __init__(self, arrays):
        if isinstance(arrays, ArrayList):
            arrays = arrays.arrays
        if isinstance(arrays, Array):
            arrays = [arrays]
        if isinstance(arrays, dict):
            arrays = [cfg if isinstance(cfg, Array) else Array.from_config({"name": name, **cfg})
                      for name, cfg in arrays.items()]
        self.arrays = list(arrays)

    def combine(self) -> Array:
        """One Array of every array's rows in turn, named "a+b+...", each
        row keeping its own array's name."""
        bands, seen = [], set()
        for a in self.arrays:
            for band in a.bands:
                if band.name not in seen:
                    bands.append(band)
                    seen.add(band.name)
        combined = Array("+".join(a.name for a in self.arrays), _concat([a.dets for a in self.arrays]), bands)
        combined.dets["array_name"] = np.concatenate([np.full(a.n, a.name, dtype=object) for a in self.arrays])
        return combined

    def __iter__(self):
        return iter(self.arrays)

    def __len__(self):
        return len(self.arrays)

    def __getitem__(self, i):
        return self.arrays[i]

    def __repr__(self):
        return f"ArrayList({[a.name for a in self.arrays]})"


def get_array_config(key: str = None, **kwargs) -> dict:
    """The registry's configuration of array ``key``, with overrides."""
    config = {}
    if key:
        if key not in ARRAY_CONFIGS:
            raise ValueError(f"'{key}' is not a valid array name; known: {all_arrays}")
        config = {"name": key, **ARRAY_CONFIGS[key]}
    config.update(kwargs)
    return config


def get_array(key: str, **kwargs) -> Array:
    return Array.from_config(get_array_config(key, **kwargs))
