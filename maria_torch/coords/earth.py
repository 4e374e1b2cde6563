"""A geodetic location on the Earth (maria_tpu/coords/earth.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class EarthLocation:
    """Geodetic location: latitude/longitude in degrees, height in meters."""

    lat_deg: float = 90.0
    lon_deg: float = 0.0
    height_m: float = 0.0

    @classmethod
    def from_geodetic(cls, lon, lat, height=0.0):
        return cls(lat_deg=float(lat), lon_deg=float(lon), height_m=float(height))

    @property
    def lat(self) -> float:
        return np.radians(self.lat_deg)

    @property
    def lon(self) -> float:
        return np.radians(self.lon_deg)

    def __repr__(self):
        ns = "N" if self.lat_deg >= 0 else "S"
        ew = "E" if self.lon_deg >= 0 else "W"
        return f"EarthLocation({abs(self.lat_deg):.3f}°{ns}, {abs(self.lon_deg):.3f}°{ew}, {self.height_m:.0f} m)"


DEFAULT_EARTH_LOCATION = EarthLocation(lat_deg=90.0, lon_deg=0.0, height_m=0.0)
