from .bin_mapper import BinMapper  # noqa: F401
