"""Time-ordered data: ``TOD`` and its ``Pointing``, the processing ops,
the signal tools for real data, ``Field``, and ``load`` of a TOD file."""

from . import signal  # noqa: F401
from .field import Field  # noqa: F401
from .processing import process_tod  # noqa: F401
from .tod import TOD, Pointing  # noqa: F401


def load(fname: str, format: str = "MUSTANG-2", **kwargs) -> TOD:
    """A TOD read from a file in ``format`` (MUSTANG-2 FITS); ``kwargs``
    go to the reader (``index``, ``device``)."""
    return TOD.from_fits(fname, format=format, **kwargs)
