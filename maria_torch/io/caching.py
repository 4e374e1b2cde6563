"""Data products in the on-disk cache, made offline (maria_tpu/io/caching.py).

``fetch`` returns the cache path of a data product (a path under the
cache directory such as "maps/cluster2.fits"). A product is made by the
generator registered for the longest prefix of its path: nothing here
touches the network, and a product with no generator raises
``FileNotFoundError`` naming the download it would need. A generator
writes a private temporary file that is then renamed into place, so a
concurrent reader never takes a partial file; a cache file that does
not open for its format (empty or corrupt) is made anew, not taken as a
hit.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time

from . import get_cache_dir, set_cache_dir  # noqa: F401  (defined before io imports this module)

__all__ = ["SOURCE_BASE", "cache_status", "copy_file", "fetch", "get_cache_dir", "register_generator",
           "set_cache_dir", "test_file"]

logger = logging.getLogger("maria_torch")

SOURCE_BASE = "https://github.com/thomaswmorris/maria-data/raw/master"

# registered offline generators: path prefix -> callable(source_path, destination)
_GENERATORS: dict = {}


def register_generator(prefix: str, fn):
    """Make the products whose path starts with ``prefix`` by
    ``fn(source_path, destination)``."""
    _GENERATORS[prefix] = fn


def copy_file(source: str, destination: str):
    """Copy ``source`` to ``destination``, making its directory."""
    import shutil

    dest_dir = os.path.dirname(destination)
    if dest_dir:
        os.makedirs(dest_dir, exist_ok=True)
    shutil.copy(source, destination)


def test_file(path: str) -> bool:
    """True if the file opens cleanly for its extension: a FITS file whole
    blocks from a SIMPLE card with at least one HDU, an HDF5 file through
    h5py (where h5py is installed), anything else non-empty."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    ext = str(path).rsplit(".", 1)[-1].lower()
    if ext == "fits":
        from .fits import BLOCK, read_fits

        with open(path, "rb") as f:
            head = f.read(9)
        if os.path.getsize(path) % BLOCK or head != b"SIMPLE  =":
            return False
        try:
            return len(read_fits(path)) > 0
        except (ValueError, KeyError):
            return False
    if ext in ("h5", "hdf5"):
        try:
            import h5py
        except ImportError:
            return True
        try:
            with h5py.File(path, "r") as f:
                return len(f.keys()) > 0
        except OSError:
            return False
    return True


def cache_status(path: str, max_age: float = 30 * 86400) -> str:
    """"missing" (absent, empty or not opening for its format), "stale"
    (older than ``max_age`` seconds) or "ok"."""
    if not test_file(path):
        return "missing"
    if time.time() - os.path.getmtime(path) > max_age:
        return "stale"
    return "ok"


def _generate(fn, source_path: str, destination: str):
    directory, name = os.path.split(destination)
    ext = os.path.splitext(name)[1]
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=ext, dir=directory)
    os.close(fd)
    try:
        fn(source_path, tmp)
        os.replace(tmp, destination)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def fetch(source_path: str, cache_path: str = None, max_age: float = 30 * 86400, refresh: bool = False,
          url_base: str = SOURCE_BASE, url: str = None) -> str:
    """The local path of the data product ``source_path``: the cache's
    copy when it opens and is younger than ``max_age`` seconds (and not
    ``refresh``), else made anew by its generator (the longest registered
    prefix wins); a stale copy stands where no generator can make one.
    ``url_base`` and ``url`` only name the download in the error of a
    product that cannot be made offline."""
    destination = cache_path or os.path.join(get_cache_dir(), source_path)
    os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
    status = cache_status(destination, max_age=max_age)
    if status == "ok" and not refresh:
        return destination
    for prefix in sorted(_GENERATORS, key=len, reverse=True):
        if source_path.startswith(prefix):
            logger.info(f"generating {source_path} into the cache")
            _generate(_GENERATORS[prefix], source_path, destination)
            return destination
    if status == "stale":
        logger.warning(f"using the stale cache of {source_path}")
        return destination
    raise FileNotFoundError(
        f"'{source_path}' has no offline generator and would need a download of {url or f'{url_base}/{source_path}'}, "
        "which this package never makes."
    )
