from .tod import TOD, Pointing  # noqa: F401
