"""HEALPix pixelization and spherical harmonic transforms (maria_tpu/healpix)."""

from .core import ang2pix_ring, npix2nside, nside2npix, pix2ang_ring, ring_info  # noqa: F401
from .sht import (  # noqa: F401
    alm2map,
    alm2map_spin,
    map2alm,
    map2alm_spin,
    synalm,
    synalm_cmb,
)
