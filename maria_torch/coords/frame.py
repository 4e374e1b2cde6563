"""Coordinate frames and their aliases (maria_tpu/coords/frame.py)."""

from __future__ import annotations

FRAMES = {
    "az/el": {
        "long_name": "",
        "aliases": ["altaz", "alt_az", "az_el"],
        "phi_name": "az",
        "theta_name": "el",
        "phi_long_name": "Azimuth",
        "theta_long_name": "Elevation",
        "fits_phi": "AZ",
        "fits_theta": "EL",
    },
    "ra/dec": {
        "long_name": "ICRS J2000",
        "aliases": ["icrs", "ra_dec", "equatorial"],
        "phi_name": "ra",
        "theta_name": "dec",
        "phi_long_name": "Right ascension (J2000)",
        "theta_long_name": "Declination (J2000)",
        "fits_phi": "RA",
        "fits_theta": "DEC",
    },
    "galactic": {
        "long_name": "Galactic",
        "aliases": ["glon/glat", "gal"],
        "phi_name": "l",
        "theta_name": "b",
        "phi_long_name": "Galactic longitude",
        "theta_long_name": "Galactic latitude",
        "fits_phi": "GLON",
        "fits_theta": "GLAT",
    },
}


def parse_frame(frame) -> str:
    if isinstance(frame, Frame):
        return frame.name
    for key, config in FRAMES.items():
        if frame in (key, *config["aliases"]):
            return key
    raise ValueError(f"Invalid frame '{frame}'. Valid frames are {list(FRAMES)}.")


class Frame:
    def __init__(self, frame):
        self.name = parse_frame(frame)

    def __getattr__(self, key):
        config = FRAMES[self.name]
        if key in config:
            return config[key]
        raise AttributeError(key)

    def __repr__(self):
        return f"Frame('{self.name}')"

    def __str__(self):
        return self.name

    def __eq__(self, other):
        return self.name == (other.name if isinstance(other, Frame) else parse_frame(other))

    def __hash__(self):
        return hash(self.name)
