"""Observing sites and regions (maria_tpu/site): the 26 named sites with
their aliases and altitude overrides, and the 25 regions with their
geography and the climatological pwv of the synthetic weather, stored as
JSON (``regions``). A region's name is a site of its own. The world
height map is downloaded data and is not ported."""

from __future__ import annotations

from ..coords.earth import EarthLocation
from ..io import read_config
from .regions import REGIONS, all_regions

__all__ = ["REGIONS", "SITE_CONFIGS", "Site", "all_regions", "all_sites", "get_location", "get_region", "get_site",
           "get_site_config"]

SITE_CONFIGS = read_config("sites")
all_sites = sorted(SITE_CONFIGS)


def get_region(region: str) -> dict:
    if region not in REGIONS:
        raise ValueError(f"'{region}' is not a valid region; known: {all_regions}")
    return dict(REGIONS[region])


class Site:
    """A region with its location; ``documentation`` is kept and any other
    keyword of a site's configuration is accepted and ignored, as
    maria_tpu's Site does."""

    def __init__(self, region: str, altitude: float = None, latitude: float = None,
                 longitude: float = None, description: str = "", documentation: str = "", name: str = None,
                 **extra):
        entry = get_region(region)
        self.name = name or region
        self.region = region
        self.description = description
        self.documentation = documentation
        self.latitude = float(latitude if latitude is not None else entry["latitude"])
        self.longitude = float(longitude if longitude is not None else entry["longitude"])
        self.altitude = float(altitude if altitude is not None else entry["altitude"])

    @property
    def earth_location(self) -> EarthLocation:
        return EarthLocation(self.latitude, self.longitude, self.altitude)

    def __repr__(self):
        return f"Site({self.name}: region={self.region}, altitude={self.altitude} m)"


def _named(site_name: str):
    for name, config in SITE_CONFIGS.items():
        if site_name == name or site_name in config.get("aliases", []):
            return name, {k: v for k, v in config.items() if k != "aliases"}
    return None, None


def get_site_config(site_name: str = "hoagie_haven", **kwargs) -> dict:
    """The configuration of a named site (or alias), with overrides."""
    name, cfg = _named(site_name)
    if name is None:
        raise ValueError(f"'{site_name}' is not a valid site; known: {all_sites}")
    return {**cfg, **kwargs}


def get_site(site_name: str, **kwargs) -> Site:
    """A named site (or alias) or a region, with overrides such as
    ``altitude=``."""
    name, cfg = _named(site_name)
    if name is not None:
        return Site(name=name, **{**cfg, **kwargs})
    if site_name in REGIONS:
        return Site(region=site_name, **kwargs)
    raise ValueError(f"'{site_name}' is not a valid site or region; known: {all_sites + all_regions}")



def get_location(site_name: str) -> EarthLocation:
    """The EarthLocation of a named site, alias or region."""
    return get_site(site_name).earth_location
