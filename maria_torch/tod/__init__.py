from .processing import process_tod  # noqa: F401
from .tod import TOD, Pointing  # noqa: F401
