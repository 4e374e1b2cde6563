"""Observing regions (maria_tpu/site/regions.py): each region's
location, country, latitude and longitude in degrees, altitudes in
metres, UTC offset and the climatological median pwv of the synthetic
weather, stored as JSON. maria_tpu holds the table as a pandas
DataFrame indexed by name; here ``REGIONS`` maps a name to its row and
``REGION_COLUMNS`` holds the table as numpy columns, "name" first."""

from __future__ import annotations

import numpy as np

from ..io import read_config

__all__ = ["REGIONS", "REGION_COLUMNS", "all_regions"]

REGIONS = read_config("regions")
all_regions = list(REGIONS)
REGION_COLUMNS = {"name": np.array(all_regions),
                  **{col: np.array([REGIONS[r][col] for r in all_regions]) for col in next(iter(REGIONS.values()))}}
