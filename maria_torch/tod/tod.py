"""Time-ordered data (maria_tpu/tod/tod.py): fields are (n_det, n_t)
float32 tensors on the simulation's device; the pointing stays
factorized as the boresight track times static detector offsets.
``TOD.to`` converts between the quantities of ``VALID_TOD_QUANTITIES``
through the calibration graph, on the TOD's device. ``TOD.process``
runs the ops of ``tod.processing``. A TOD is cut by detector and time
(``tod[mask]``, ``tod["f150"]``, ``tod[::2, :1000]``, ``subset``) on its
device, split at the scan's turnarounds (``splits``), written and read
as HDF5 (``to_hdf``, ``from_hdf``; h5py) and in the MUSTANG-2 FITS
format (``to_fits``, ``from_fits``), and plotted (``plot``;
matplotlib)."""

from __future__ import annotations

import numpy as np
import torch

from ..array.rows import device_rows
from ..coords import Coordinates, offsets_to_phi_theta
from ..device import check_float32, resolve_device
from ..ops.interp import interp
from ..ops.pixel_ids import sky_offsets
from ..units import Quantity, parse_units

__all__ = ["TOD", "Pointing", "VALID_TOD_QUANTITIES"]

VALID_TOD_QUANTITIES = ["power", "rayleigh_jeans_temperature", "cmb_temperature_anisotropy", "brightness_temperature"]


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), dtype=torch.float32, device=resolve_device(device))


class Pointing:
    """Factorized pointing: the boresight track, the detector offsets
    (az/el frame) and the az/el -> ra/dec frame-rotation angle q(t),
    which only the ra/dec pointing needs."""

    def __init__(self, boresight, offsets, q=None):
        self.boresight = boresight
        self.offsets = np.asarray(offsets)
        self.q = None if q is None else np.asarray(q)

    @property
    def t(self):
        return self.boresight.t

    @property
    def shape(self):
        return (len(self.offsets), len(self.t))

    def det_azel(self, device=None, idx=None):
        """(az, el) float32 tensors of shape (n_det, n_t) on ``device``,
        of the detectors ``idx`` (all by default)."""
        offsets = self.offsets if idx is None else self.offsets[idx]
        pt = offsets_to_phi_theta(
            _f32(offsets[:, None, :], device), _f32(self.boresight.az, device), _f32(self.boresight.el, device)
        )
        return pt[..., 0], pt[..., 1]

    def offsets_radec(self, device=None, idx=None):
        """Detector offsets in the ra/dec frame, R(q(t)) @ offsets, a
        float32 tensor (n_det, n_t, 2) built on ``device`` from the host's
        float64 q."""
        if self.q is None:
            raise ValueError("this Pointing was made without the frame-rotation angle q")
        offsets = _f32(self.offsets if idx is None else self.offsets[idx], device)
        return sky_offsets(offsets, _f32(np.cos(self.q), device), _f32(np.sin(self.q), device))

    def det_radec(self, device=None, idx=None):
        """(ra, dec) float32 tensors of shape (n_det, n_t), as ``det_azel``."""
        pt = offsets_to_phi_theta(
            self.offsets_radec(device=device, idx=idx), _f32(self.boresight.ra, device),
            _f32(self.boresight.dec, device),
        )
        return pt[..., 0], pt[..., 1]

    def factors(self, frame: str, device=None):
        """The factorized pointing in ``frame`` ("az/el" or "ra/dec") as
        float32 tensors on ``device``, the values ``det_azel`` and
        ``det_radec`` start from: (offsets (n_det, 2), phi (n_t,), theta
        (n_t,), cos q, sin q), the boresight's angles and, in ra/dec, cos
        and sin of q(t) (None in az/el). One copy to the device for the
        offsets and one for the tracks."""
        b = self.boresight
        if frame == "az/el":
            tracks = [b.az, b.el]
        elif frame == "ra/dec":
            if self.q is None:
                raise ValueError("this Pointing was made without the frame-rotation angle q")
            tracks = [b.ra, b.dec, np.cos(self.q), np.sin(self.q)]
        else:
            raise ValueError(f"frame must be 'az/el' or 'ra/dec', got {frame!r}")
        tracks = _f32(np.stack([np.asarray(x, dtype=np.float32) for x in tracks]), device)
        return (_f32(self.offsets, device), *tracks, *([None, None] if frame == "az/el" else []))

    def coordinates(self) -> Coordinates:
        """Every detector's pointing, (n_det, n_t) host Coordinates in
        az/el (memory-heavy: the factorized form is what the TOD keeps)."""
        return self.boresight.broadcast(self.offsets, frame="az/el")

    def __getitem__(self, idx) -> "Pointing":
        """The detectors ``idx``."""
        return Pointing(self.boresight, self.offsets[idx], self.q)

    def time_subset(self, idx) -> "Pointing":
        """The samples ``idx`` (an index array or a slice) of every
        detector; the frames are recomputed on the cut boresight."""
        b = self.boresight
        cut = Coordinates(phi=np.asarray(b._phi)[idx], theta=np.asarray(b._theta)[idx], t=np.asarray(b.t)[idx],
                          earth_location=b.earth_location, frame=b.frame.name)
        return Pointing(cut, self.offsets, None if self.q is None else self.q[idx])


def _table_convert(cal, d):
    """A non-linear elementwise chain on the field ``d`` (a float32
    tensor): evaluated on the host in float64 at 1,025 points over the
    field's range widened by 1% a side, then interpolated on the device in
    coordinates offset by the table's first point, which keep float32's
    precision (maria_tpu/tod/tod.py:280-299)."""
    lo, hi = float(d.min()), float(d.max())
    span = max(hi - lo, 1e-9 * max(abs(hi), abs(lo), 1.0))
    grid = np.linspace(lo - 0.01 * span, hi + 0.01 * span, 1025)
    y_grid = np.asarray(cal(grid), dtype=float)
    y0 = y_grid[0]
    f32 = dict(dtype=torch.float32, device=d.device)
    out = interp(d - float(np.float32(grid[0])), torch.as_tensor(grid - grid[0], **f32),
                 torch.as_tensor(y_grid - y0, **f32))
    return out + float(np.float32(y0))


class TOD:
    """Fields of (n_det, n_t) float32 tensors with their detectors,
    pointing, weight and units. ``dtype`` must be float32; ``abscal``
    is kept as given (maria_tpu stores it and applies it nowhere)."""

    def __init__(self, data: dict, pointing: Pointing = None, weight=None, units: str = "K_RJ",
                 dets=None, metadata: dict = {}, spectrum=None, coords: Coordinates = None, dtype=torch.float32,
                 abscal: float = 1.0):
        check_float32(dtype)
        self.dtype = torch.float32
        self.abscal = abscal
        self.pointing = pointing
        self._coords = coords
        self._spectrum = spectrum
        self.dets = dets
        self.units = units
        self.metadata = dict(metadata)
        self.data = {k: v.to(torch.float32) for k, v in sorted(data.items())}
        first = self.data[self.fields[0]]
        self.weight = weight if weight is not None else torch.ones_like(first)

    @property
    def fields(self):
        return sorted(self.data)

    @property
    def device(self):
        return self.data[self.fields[0]].device

    @property
    def signal(self):
        total = 0
        for field in self.fields:
            total = total + self.data[field]
        return total

    @property
    def shape(self):
        return tuple(self.data[self.fields[0]].shape)

    @property
    def time(self):
        return self.pointing.t

    @property
    def fs(self) -> float:
        """The sample rate in Hz."""
        return float(1 / np.mean(np.diff(self.time)))

    @property
    def duration(self) -> float:
        """Seconds from the first sample to the last."""
        return float(np.ptp(self.time))

    @property
    def sample_rate(self) -> Quantity:
        return Quantity(self.fs, "Hz")

    @property
    def coords(self) -> Coordinates:
        """Every detector's pointing as host Coordinates (made once)."""
        if self._coords is None:
            self._coords = self.pointing.coordinates()
        return self._coords

    @property
    def azim(self) -> np.ndarray:
        """The boresight's azimuth, host float64."""
        return np.asarray(self.pointing.boresight.az)

    @property
    def elev(self) -> np.ndarray:
        """The boresight's elevation, host float64."""
        return np.asarray(self.pointing.boresight.el)

    @property
    def el(self):
        """The detectors' elevation (n_det, n_t), a float32 tensor on the TOD's device."""
        return self.pointing.det_azel(device=self.device)[1]

    @property
    def boresight(self):
        return self.pointing.boresight

    @property
    def spectrum(self):
        """The atmospheric spectrum the TOD was simulated with (loaded
        for its region when the TOD was made without one)."""
        if self._spectrum is None and self.metadata.get("atmosphere"):
            from ..spectrum import AtmosphericSpectrum

            self._spectrum = AtmosphericSpectrum(self.metadata["region"])
        return self._spectrum

    def calibration_kwargs(self, band, idx=None) -> dict:
        """The calibration keywords of the band's detectors ``idx``: the
        polarized factor (maria_tpu's: the band counts as polarized when
        any of its detectors is, ROADMAP queue 3, hazard 8) and, with an
        atmosphere, the spectrum, the observation's pwv and base
        temperature and the detectors' elevations, a tensor on the TOD's
        device."""
        if idx is None:
            names = self.dets.bands.names
            idx = self.dets.band_rows()[names.index(band.name)] if band.name in names else np.zeros(0, np.int64)
        kwargs = {"polarized": bool(~np.isnan(self.dets.gamma[idx]).all()), "spectrum": None}
        if self.metadata.get("atmosphere"):
            _, el = self.pointing.det_azel(device=self.device, idx=idx)
            kwargs.update(spectrum=self.spectrum, zenith_pwv=self.metadata["pwv"],
                          base_temperature=self.metadata["base_temperature"],
                          elevation=torch.clamp(el, max=float(np.pi / 2)))
        return kwargs

    def to(self, units: str) -> "TOD":
        """The TOD in ``units``, band by band through the calibration graph.
        A linear chain is one factor a sample (a tensor of the band's
        elevations with an atmosphere), computed on the TOD's device. A
        non-linear chain with an atmosphere is evaluated on the device
        sample by sample (or raises, as maria_tpu's chain raises); in a
        vacuum it is maria_tpu's 1,025-point host table over the field's
        range, interpolated on the device."""
        if units == self.units:
            return self
        u = parse_units(units)
        if u.quantity not in VALID_TOD_QUANTITIES:
            raise ValueError(f"Cannot convert TOD to units '{units}' (quantity '{u.quantity}').")
        new_data = {k: v.clone() for k, v in self.data.items()}
        for band, idx, rows in zip(self.dets.bands, self.dets.band_rows(), self.dets.band_rows_on(self.device)):
            kwargs = self.calibration_kwargs(band, idx)
            cal = band.cal(f"{self.units} -> {units}", **kwargs)
            if cal.linear():
                factor = cal(1.0)
                factor = factor if isinstance(factor, torch.Tensor) else float(factor)
                for field in self.fields:
                    new_data[field][rows] = self.data[field][rows] * factor
            elif kwargs["spectrum"] is not None:
                for field in self.fields:
                    new_data[field][rows] = cal(self.data[field][rows]).to(torch.float32)
            else:
                for field in self.fields:
                    new_data[field][rows] = _table_convert(cal, self.data[field][rows])
        return TOD(data=new_data, pointing=self.pointing, weight=self.weight, units=units,
                   dets=self.dets, metadata=self.metadata, spectrum=self._spectrum)

    def _like(self, data: dict, pointing, weight, dets=None) -> "TOD":
        return TOD(data=data, pointing=pointing, weight=weight, units=self.units,
                   dets=self.dets if dets is None else dets, metadata=self.metadata, spectrum=self._spectrum)

    def __getitem__(self, idx) -> "TOD":
        """The detectors ``idx`` (a band name, a mask, indices or a slice)
        in their order, and with a second index the samples it picks:
        ``tod["f090"]``, ``tod[mask]``, ``tod[::2, :10000]``."""
        time_idx = None
        if isinstance(idx, tuple):
            if len(idx) > 2:
                raise IndexError(f"A TOD has 2 axes (det, time); got {len(idx)} indices.")
            idx, time_idx = (idx + (None,))[:2]
        if isinstance(idx, str):
            idx = self.dets.mask(band_name=idx)
        if isinstance(idx, slice):
            idx = np.arange(self.shape[0])[idx]
        idx = np.array(np.atleast_1d(idx))
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        rows = device_rows(idx, self.device)

        def take(v):  # the new TOD owns its rows: a slice's view is copied, as a gather copies
            return v[rows].clone() if isinstance(rows, slice) else v[rows]

        out = self._like({k: take(v) for k, v in self.data.items()},
                         self.pointing[idx] if self.pointing is not None else None, take(self.weight),
                         dets=self.dets.take(idx) if self.dets is not None else None)
        if time_idx is not None:
            if not isinstance(time_idx, slice):
                time_idx = np.atleast_1d(time_idx)
            cols = time_idx if isinstance(time_idx, slice) else torch.as_tensor(np.array(time_idx), device=self.device)
            out = out._like({k: v[:, cols] for k, v in out.data.items()},
                            out.pointing.time_subset(time_idx) if out.pointing is not None else None,
                            out.weight[:, cols])
        return out

    def get_field(self, field: str):
        """One simulated component's tensor: ``tod.get_field("atmosphere")``."""
        if field not in self.data:
            raise KeyError(f"No field '{field}' (available: {sorted(self.data)}).")
        return self.data[field]

    def subset(self, det_mask=None, time_range=None) -> "TOD":
        """The detectors ``det_mask`` and the samples [start, stop) of
        ``time_range``."""
        out = self[det_mask] if det_mask is not None else self
        if time_range is not None:
            s, e = time_range
            out = out._like({k: v[..., s:e] for k, v in out.data.items()},
                            out.pointing.time_subset(slice(s, e)) if out.pointing is not None else None,
                            out.weight[..., s:e])
        return out

    @property
    def turnarounds(self) -> np.ndarray:
        """The samples where the boresight's azimuth sweep turns: sign
        changes of its gradient smoothed by a Gaussian of 16 samples."""
        import scipy.ndimage

        azim_grad = scipy.ndimage.gaussian_filter(np.gradient(self.azim), sigma=16)
        return np.where(np.sign(azim_grad[:-1]) != np.sign(azim_grad[1:]))[0]

    def splits(self, target_split_time: float = None) -> list:
        """(start, stop) samples of the scans between turnarounds (the
        whole TOD without two of them), each cut into pieces of about
        ``target_split_time`` seconds when it is given."""
        turnarounds = self.turnarounds
        if len(turnarounds) < 2:
            turnarounds = np.array([0, self.shape[-1] - 1])
        if target_split_time is None:
            return list(zip(turnarounds[:-1], turnarounds[1:]))
        fs = self.fs
        out = []
        for s, e in zip(turnarounds[:-1], turnarounds[1:]):
            n_splits = int(np.ceil((e - s) / fs / target_split_time))
            n_samples = int(target_split_time * fs)
            for start in np.linspace(s, max(e - n_samples, s), n_splits).astype(int):
                out.append((start, min(start + n_samples, e)))
        return out

    # -- files -----------------------------------------------------------------------------
    def to_hdf(self, fname: str):
        """Every field, the weights, the factorized pointing, the detector
        table's columns and the bands' configurations, and the metadata
        JSON can hold, as HDF5 (needs h5py); ``from_hdf`` reads it back
        bit for bit."""
        import json

        import h5py

        metadata = {}
        for key, value in self.metadata.items():
            try:
                metadata[key] = json.loads(json.dumps(value))
            except TypeError:
                continue  # an object (the simulation's input map) is not kept
        with h5py.File(fname, "w") as f:
            g = f.create_group("data")
            for k, v in self.data.items():
                g.create_dataset(k, data=v.detach().cpu().numpy())
            f.create_dataset("weight", data=self.weight.detach().cpu().numpy())
            f.attrs["units"] = self.units
            f.attrs["metadata"] = json.dumps(metadata)
            if self.pointing is not None:
                b = self.pointing.boresight
                p = f.create_group("pointing")
                p.create_dataset("phi", data=np.asarray(b._phi))
                p.create_dataset("theta", data=np.asarray(b._theta))
                p.create_dataset("t", data=np.asarray(b.t))
                p.create_dataset("offsets", data=np.asarray(self.pointing.offsets))
                if self.pointing.q is not None:
                    p.create_dataset("q", data=np.asarray(self.pointing.q))
                p.attrs["frame"] = b.frame.name
                p.attrs["lat_deg"] = b.earth_location.lat_deg
                p.attrs["lon_deg"] = b.earth_location.lon_deg
                p.attrs["height_m"] = b.earth_location.height_m
            if self.dets is not None:
                d = f.create_group("dets")
                for key, column in self.dets.dets.items():
                    column = np.asarray(column)
                    d.create_dataset(key, data=column.astype(str).astype("S") if column.dtype == object else column)
                d.attrs["name"] = self.dets.name
                d.attrs["bands"] = json.dumps([band.to_config() for band in self.dets.bands])

    @classmethod
    def from_hdf(cls, fname: str, device=None) -> "TOD":
        """The TOD ``to_hdf`` wrote, its fields on ``device``."""
        import json

        import h5py

        from ..array import Array
        from ..band import Band
        from ..coords import EarthLocation

        device = resolve_device(device)
        with h5py.File(fname, "r") as f:
            data = {k: torch.as_tensor(np.array(v), device=device) for k, v in f["data"].items()}
            weight = torch.as_tensor(np.array(f["weight"]), device=device)
            units = str(f.attrs["units"])
            metadata = json.loads(f.attrs["metadata"])
            pointing = None
            if "pointing" in f:
                p = f["pointing"]
                location = EarthLocation(lat_deg=float(p.attrs["lat_deg"]), lon_deg=float(p.attrs["lon_deg"]),
                                         height_m=float(p.attrs["height_m"]))
                boresight = Coordinates(phi=np.array(p["phi"]), theta=np.array(p["theta"]), t=np.array(p["t"]),
                                        earth_location=location, frame=str(p.attrs["frame"]))
                pointing = Pointing(boresight, np.array(p["offsets"]), np.array(p["q"]) if "q" in p else None)
            dets = None
            if "dets" in f:
                columns = {k: np.array(v) for k, v in f["dets"].items()}
                columns = {k: v.astype(str).astype(object) if v.dtype.kind == "S" else v for k, v in columns.items()}
                bands = [Band(**cfg) for cfg in json.loads(f["dets"].attrs["bands"])]
                dets = Array(str(f["dets"].attrs["name"]), columns, bands)
                dets.dets["array_name"] = columns["array_name"]
        return cls(data=data, pointing=pointing, weight=weight, units=units, dets=dets, metadata=metadata)

    def to_fits(self, fname: str, format: str = "MUSTANG-2"):
        """The TOD as a MUSTANG-2 binary table (maria_tpu/tod/tod.py): the
        detectors' ra/dec (DX, DY, float32 radians), the K_RJ signal (FNU),
        the time from the first sample (TIME) and the detector (PIXID), a
        row a sample, detector by detector."""
        if format.lower() not in ("mustang-2", "mustang2"):
            raise ValueError(f"Unsupported TOD format '{format}'.")
        from ..io.fits import write_fits_bintable

        ra, dec = self.pointing.det_radec(device=self.device)
        tod_rj = self.to("K_RJ")
        n_det, n_t = self.shape
        rel_t = np.broadcast_to(self.time - self.time[0], (n_det, n_t))
        pixid = np.broadcast_to(np.arange(n_det, dtype=np.int16)[:, None], (n_det, n_t))
        c_az, c_el = self.pointing.boresight.center(frame="az/el")
        location = self.pointing.boresight.earth_location
        write_fits_bintable(
            fname,
            columns=[
                ("DX   ", "E", ra.cpu().numpy().ravel(), "radians"),
                ("DY   ", "E", dec.cpu().numpy().ravel(), "radians"),
                ("FNU  ", "E", tod_rj.signal.cpu().numpy().ravel(), "K_RJ"),
                ("UFNU ", "E", None, ""),
                ("TIME ", "E", rel_t.ravel(), "s"),
                ("COL  ", "I", None, ""),
                ("ROW  ", "I", None, ""),
                ("PIXID", "I", pixid.ravel(), ""),
                ("SCAN ", "I", None, ""),
                ("ELEV ", "E", None, ""),
            ],
            header_cards=[
                ("AZIM", float(c_az), "radians"),
                ("ELEV", float(c_el), "radians"),
                ("NDETS", n_det),
                ("JDSTART", self.time[0] / 86400.0 + 2440587.5),
                ("SITELAT", location.lat_deg),
                ("SITELONG", location.lon_deg),
                ("SITEELEV", location.height_m),
            ],
        )

    @classmethod
    def from_fits(cls, fname: str, format: str = "MUSTANG-2", **kwargs) -> "TOD":
        """A TOD of a FITS file in ``format`` (MUSTANG-2)."""
        if format.lower() in ("mustang-2", "mustang2"):
            return cls._from_mustang2(fname, **kwargs)
        raise ValueError(f"Unsupported TOD format '{format}'.")

    @classmethod
    def _from_mustang2(cls, fname: str, index: int = 1, device=None) -> "TOD":
        """A MUSTANG-2 binary table as maria_tpu reads it: the boresight
        the detectors' mean ra/dec, the offsets their spread at the first
        sample, q = 0, every detector in band m2/f093 at the GBT; the
        signal on ``device``."""
        from ..array import Array
        from ..band import get_band
        from ..io.fits import read_fits
        from ..site import get_site

        header, raw = read_fits(fname)[index]
        det_uids, det_counts = np.unique(raw["PIXID"], return_counts=True)
        if det_counts.std() > 0:
            raise ValueError("Cannot reshape a ragged TOD.")
        n_det, n_t = len(det_uids), int(det_counts.max())
        signal = raw["FNU"].astype(np.float32).reshape(n_det, n_t)
        ra = raw["DX"].astype(float).reshape(n_det, n_t)
        dec = raw["DY"].astype(float).reshape(n_det, n_t)
        t = raw["TIME"].astype(float).reshape(n_det, n_t).mean(axis=0)
        if "JDSTART" in header:
            t = t + (header["JDSTART"] - 2440587.5) * 86400.0

        site = get_site("GBT")
        boresight = Coordinates(phi=ra.mean(axis=0), theta=dec.mean(axis=0), t=t,
                                earth_location=site.earth_location, frame="ra/dec")
        offsets = np.stack([-(ra[:, 0] - ra[:, 0].mean()) * np.cos(dec[:, 0].mean()), dec[:, 0] - dec[:, 0].mean()],
                           axis=-1)
        band = get_band("m2/f093")
        dets = {
            "base_det_index": np.arange(n_det), "xi": offsets[:, 0], "eta": offsets[:, 1],
            "baseline_x": np.zeros(n_det), "baseline_y": np.zeros(n_det), "baseline_z": np.zeros(n_det),
            "gamma": np.full(n_det, np.nan), "pol_label": np.full(n_det, "none", dtype=object),
            "primary_size": np.full(n_det, 100.0), "bath_temp": np.full(n_det, 0.3),
            "time_constant": np.zeros(n_det), "band_name": np.full(n_det, band.name, dtype=object),
        }
        metadata = {"atmosphere": False, "altitude": site.altitude, "region": site.region, "real_obs": True,
                    "base_temperature": header.get("TAMBIENT")}
        signal = torch.as_tensor(signal, device=resolve_device(device))
        return cls(data={"signal": signal}, pointing=Pointing(boresight, offsets, q=np.zeros(n_t)),
                   dets=Array("mustang2", dets, [band]), units="K_RJ", metadata=metadata)

    def plot(self, **kwargs):
        """Each band's timelines and binned power spectra
        (``plotting.plot_tod``; needs matplotlib)."""
        from ..plotting import plot_tod

        return plot_tod(self, **kwargs)

    def process(self, **config) -> "TOD":
        """The TOD processed by ``tod.processing.process_tod``: one "signal" field."""
        from .processing import process_tod

        return process_tod(self, **config)

    def __repr__(self):
        return f"TOD(shape={self.shape}, fields={self.fields}, units={self.units}, device={self.device})"
