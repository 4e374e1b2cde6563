"""Observing sites and regions (maria_tpu/site): the entries the port's
configurations use, stored as JSON."""

from __future__ import annotations

from ..io import read_config

__all__ = ["Site", "get_site", "get_region"]


def get_region(region: str) -> dict:
    regions = read_config("regions")
    if region not in regions:
        raise NotImplementedError(
            f"region '{region}' (ROADMAP queue 1, item 13: other instruments and sites); "
            f"supported: {sorted(regions)}"
        )
    return regions[region]


class EarthLocation:
    def __init__(self, lat_deg: float, lon_deg: float, height_m: float):
        self.lat_deg = lat_deg
        self.lon_deg = lon_deg
        self.height_m = height_m

    def __repr__(self):
        return f"EarthLocation(lat={self.lat_deg}°, lon={self.lon_deg}°, h={self.height_m} m)"


class Site:
    def __init__(self, region: str, altitude: float = None, latitude: float = None,
                 longitude: float = None, description: str = "", name: str = None):
        entry = get_region(region)
        self.name = name or region
        self.region = region
        self.description = description
        self.latitude = float(latitude if latitude is not None else entry["latitude"])
        self.longitude = float(longitude if longitude is not None else entry["longitude"])
        self.altitude = float(altitude if altitude is not None else entry["altitude"])

    @property
    def earth_location(self) -> EarthLocation:
        return EarthLocation(self.latitude, self.longitude, self.altitude)

    def __repr__(self):
        return f"Site({self.name}: region={self.region}, altitude={self.altitude} m)"


def get_site(site_name: str, **kwargs) -> Site:
    for name, config in read_config("sites").items():
        if site_name == name or site_name in config.get("aliases", []):
            cfg = {k: v for k, v in config.items() if k != "aliases"}
            cfg.update(kwargs)
            return Site(name=name, **cfg)
    raise NotImplementedError(
        f"site '{site_name}' (ROADMAP queue 1, item 13: other instruments and sites)"
    )
