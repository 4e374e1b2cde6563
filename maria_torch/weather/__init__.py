"""Site weather from the parametric per-region climatology
(numpy port of maria_tpu/weather/__init__.py, without pandas): a
standard-atmosphere column on pressure levels, a lognormal pwv around the
region's median, and winds strengthening toward the jet; and the moist
air's thermodynamics (vapor pressure, dew point, density). Where
maria_tpu returns a DataFrame (``Weather.layers``), this returns a dict
of numpy columns."""

from __future__ import annotations

import time as _time
import zlib

import numpy as np
import scipy as sp

from ..constants import DRY_AIR_SPECIFIC_GAS_CONSTANT, WATER_VAPOR_SPECIFIC_GAS_CONSTANT, g
from ..site import get_region
from ..utils import get_utc_day_hour, get_utc_year_day

# where maria_tpu's ERA5 quantile grids live; the port computes the
# synthetic climatology only (a download is not ported)
WEATHER_SOURCE_BASE = "https://github.com/thomaswmorris/maria-data/raw/master/atmosphere/weather"

PRESSURE_LEVELS = np.array(
    [1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750, 700, 650,
     600, 550, 500, 450, 400, 350, 300, 250, 225, 200, 175, 150, 125, 100, 70, 50],
    dtype=float,
)


def saturation_pressure(temperature):  # K -> Pa
    T = temperature - 273.15
    a, b, c = 611.21, 17.67, 238.88
    return a * np.exp(b * T / (c + T))


def vapor_pressure(temperature, humidity):  # (K, fraction in [0, 1]) -> Pa
    """Partial pressure of water vapor at relative humidity ``humidity``
    (a fraction: 1 is saturation), Magnus form."""
    return np.clip(humidity, 1e-8, None) * saturation_pressure(temperature)


def dew_point(temperature, humidity):  # (K, fraction in [0, 1]) -> K
    """Magnus-formula dew point."""
    a, b, c = 611.21, 17.67, 238.88
    log_ratio = np.log(vapor_pressure(temperature, humidity) / a)
    return c * log_ratio / (b - log_ratio) + 273.15


def dew_point_to_relative_humidity(temperature, dew_point):  # (K, K) -> fraction
    T, DP = temperature - 273.15, dew_point - 273.15
    b, c = 17.67, 238.88
    return np.exp(b * DP / (c + DP) - b * T / (c + T))


def air_density(pressure, temperature, humidity):  # (Pa, K, fraction) -> kg/m^3
    """Moist-air density from the partial pressures of vapor and dry air."""
    vp = vapor_pressure(temperature, humidity)
    return vp / (WATER_VAPOR_SPECIFIC_GAS_CONSTANT * temperature) + (pressure - vp) / (
        DRY_AIR_SPECIFIC_GAS_CONSTANT * temperature
    )


def relative_to_absolute_humidity(temperature, humidity_frac):
    return humidity_frac * saturation_pressure(temperature) / (461.5 * temperature)


def absolute_to_relative_humidity(temperature, abs_hum):
    return 461.5 * temperature * abs_hum / saturation_pressure(temperature)


def _standard_altitude_of_pressure(p_hPa):
    p = np.asarray(p_hPa, dtype=float)
    tropo = 44330.7 * (1 - (p / 1013.25) ** 0.190266)
    strato = 11e3 + 6341.6 * np.log(226.32 / np.clip(p, 1e-3, None))
    return np.where(p > 226.32, tropo, strato)


class Weather:
    """``refresh_cache`` is kept for maria_tpu's signature: the synthetic
    source is computed, not cached."""

    def __init__(self, region: str = "chajnantor", time: float = None, altitude: float = None,
                 quantiles: dict = {}, override: dict = {}, source: str = "synthetic", refresh_cache: bool = False):
        if source != "synthetic":
            raise NotImplementedError(
                f"weather source '{source}' (ROADMAP queue 1, item 13: other scene sources)"
            )
        self.region = region
        self.entry = get_region(region)
        self.base_altitude = float(altitude if altitude is not None else self.entry["altitude"])
        self.quantiles = dict(quantiles)
        self.override = dict(override)
        self.time = float(time if time is not None else _time.time())

        utc_day_hour = get_utc_day_hour(self.time)
        utc_year_day = get_utc_year_day(self.time)
        local_hour = (utc_day_hour + self.entry["utc_offset_hr"]) % 24
        lat = float(self.entry["latitude"])

        T_mean = 288.15 - 6.5e-3 * self.base_altitude - 0.45 * max(abs(lat) - 18.0, 0.0)
        season_phase = 2 * np.pi * (utc_year_day - 200.0) / 365.25
        season_sign = 1.0 if lat >= 0 else -1.0
        A_season = 3.0 + 15.0 * (abs(lat) / 90.0) ** 1.5
        A_diurnal = 6.0 * np.exp(-self.base_altitude / 6e3)
        q_t = sp.stats.norm.ppf(np.clip(self.quantiles.get("temperature", 0.5), 1e-3, 1 - 1e-3))
        T_base = (
            T_mean
            + season_sign * A_season * np.cos(season_phase)
            + A_diurnal * np.cos(2 * np.pi * (local_hour - 14.0) / 24.0)
            + 4.0 * q_t
        )

        level_altitude = _standard_altitude_of_pressure(PRESSURE_LEVELS)
        h_rel = level_altitude - self.base_altitude
        temperature = np.where(
            level_altitude < 11e3,
            T_base - 6.5e-3 * h_rel,
            T_base - 6.5e-3 * (11e3 - self.base_altitude),
        )
        temperature = np.maximum(temperature, 185.0)

        pwv_median = float(self.entry["pwv_scale_mm"]) * (1 + 0.5 * season_sign * np.cos(season_phase))
        pwv_median *= 1 + 0.15 * np.cos(2 * np.pi * (local_hour - 16.0) / 24.0)
        q_pwv = sp.stats.norm.ppf(np.clip(self.quantiles.get("pwv", 0.5), 1e-3, 1 - 1e-3))
        pwv_target = max(pwv_median * np.exp(0.55 * q_pwv), 0.05)

        w_shape = np.exp(-np.maximum(h_rel, 0.0) / 2000.0) * (h_rel > -500)
        abs_humidity = relative_to_absolute_humidity(temperature, 0.5) * w_shape
        above = h_rel > 0
        column = np.trapezoid(abs_humidity[above], x=level_altitude[above])
        abs_humidity *= pwv_target / max(column, 1e-8)
        sat_ah = relative_to_absolute_humidity(temperature, 1.0)
        for _ in range(8):
            over = abs_humidity > sat_ah
            excess = np.trapezoid(
                np.where(over, abs_humidity - sat_ah, 0.0)[above], x=level_altitude[above]
            )
            abs_humidity = np.minimum(abs_humidity, sat_ah)
            if excess <= 1e-9:
                break
            free = ~over & (w_shape > 0) & above
            room = np.trapezoid(np.where(free, abs_humidity, 0.0)[above], x=level_altitude[above])
            if room <= 1e-9:
                break
            abs_humidity = np.where(free, abs_humidity * (1 + excess / room), abs_humidity)
        humidity = np.clip(absolute_to_relative_humidity(temperature, abs_humidity), 1e-4, 1.0)

        q_w = sp.stats.norm.ppf(np.clip(self.quantiles.get("wind_speed", 0.5), 1e-3, 1 - 1e-3))
        jet = 28.0 * (0.7 + 0.45 * np.cos(season_phase) * season_sign) * np.exp(0.35 * q_w)
        v0 = 4.5 * np.exp(0.3 * q_w)
        frac = np.clip((1013.25 - PRESSURE_LEVELS) / (1013.25 - 200.0), 0, 1.2)
        wind_speed = v0 + (jet - v0) * frac**2
        rng = np.random.default_rng(zlib.crc32(f"{region}/{int(utc_year_day)}".encode()))
        bearing = np.radians(270.0) + 0.6 * rng.standard_normal() + 0.15 * rng.standard_normal(len(frac))

        self.data = {
            "temperature": temperature,
            "pressure": PRESSURE_LEVELS * 1e2,
            "humidity": humidity,
            "geopotential": level_altitude * g,
            "wind_east": wind_speed * np.sin(bearing),
            "wind_north": wind_speed * np.cos(bearing),
            "wind_speed": wind_speed,
        }
        self.fields = list(self.data)

        if "pwv" in self.override:
            forced = self.override["pwv"] / self.pwv * self.absolute_humidity
            self.data["humidity"] = np.clip(
                absolute_to_relative_humidity(self.data["temperature"], forced), 1e-4, None
            )
        for key, value in self.override.items():
            if key in self.data and key != "pwv":
                self.data[key] = np.broadcast_to(np.asarray(value, dtype=float), self.data[key].shape).copy()

    def __getattr__(self, attr):
        data = self.__dict__.get("data", {})
        if attr in data:
            return data[attr]
        raise AttributeError(attr)

    @property
    def altitude(self):
        return self.data["geopotential"] / g

    @property
    def absolute_humidity(self):
        return relative_to_absolute_humidity(self.temperature, self.humidity)

    @property
    def wind_bearing(self):
        """The direction the wind blows from, radians east of north."""
        return np.arctan2(-self.wind_east, self.wind_north) % (2 * np.pi)

    def layers(self) -> dict:
        """The pressure levels above the site as numpy columns (maria_tpu
        returns a DataFrame): "altitude", the weather's fields,
        "absolute_humidity", and each level's "total_water" (mm) over
        its "h_thickness" (m) of the column."""
        keep = self.altitude > self.base_altitude
        cols = {"altitude": self.altitude[keep], **{k: v[keep] for k, v in self.data.items() if np.ndim(v)}}
        cols["absolute_humidity"] = relative_to_absolute_humidity(cols["temperature"], cols["humidity"])
        h = cols["altitude"]
        h_bins = np.array([self.base_altitude, *(h[:-1] + h[1:]) / 2, h[-1] + 100])
        total_water = np.empty(len(h))
        for i, (h1, h2) in enumerate(zip(h_bins[:-1], h_bins[1:])):
            hh = np.linspace(h1, h2, 64)
            total_water[i] = np.trapezoid(np.interp(hh, self.altitude, self.absolute_humidity), x=hh)
        cols["total_water"] = total_water
        cols["h_thickness"] = np.diff(h_bins)
        return cols

    @property
    def pwv(self) -> float:
        """Precipitable water vapor above the site, in mm."""
        altitude = self.altitude
        keep = altitude > self.base_altitude
        h = altitude[keep]
        h_bins = np.array([self.base_altitude, *(h[:-1] + h[1:]) / 2, h[-1] + 100])
        total_water = np.empty(len(h))
        for i, (h1, h2) in enumerate(zip(h_bins[:-1], h_bins[1:])):
            hh = np.linspace(h1, h2, 64)
            total_water[i] = np.trapezoid(np.interp(hh, altitude, self.absolute_humidity), x=hh)
        return float(total_water.sum())

    def __call__(self, altitude):
        """All fields interpolated to arbitrary altitudes."""
        altitude = np.asarray(altitude, dtype=float)
        return {
            field: np.interp(altitude, self.altitude, getattr(self, field))
            for field in [*self.fields, "absolute_humidity"]
        }

    def __repr__(self):
        return f"Weather(region={self.region}, pwv={self.pwv:.3f} mm)"
