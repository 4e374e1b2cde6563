from .observation import Observation  # noqa: F401
from .simulation import Simulation  # noqa: F401

BaseSimulation = Simulation  # maria_tpu's name for the same class
