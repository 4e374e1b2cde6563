"""Physical constants (SI), the same values as maria_tpu/constants.py."""

c = 2.99792458e8  # speed of light (m s^-1)
g = 9.806651  # standard gravity (m s^-2)
h = 6.62607015e-34  # Planck's constant (J s)
hbar = h / 6.283185307179586  # reduced Planck's constant (J s)
k_B = 1.380649e-23  # Boltzmann's constant (J K^-1)
T_CMB = 2.72548  # CMB monopole temperature (K)
EARTH_RADIUS = 6.378137e6  # equatorial radius of the earth (m)

# specific gas constants (J K^-1 kg^-1)
DRY_AIR_SPECIFIC_GAS_CONSTANT = 287.05
WATER_VAPOR_SPECIFIC_GAS_CONSTANT = 461.495

MIN_NU_HZ = 1e6
MAX_NU_HZ = 15e12
MARIA_MIN_NU_HZ = MIN_NU_HZ
MARIA_MAX_NU_HZ = MAX_NU_HZ
