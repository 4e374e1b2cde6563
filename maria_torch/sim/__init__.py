from .observation import Observation  # noqa: F401
from .simulation import Simulation  # noqa: F401
