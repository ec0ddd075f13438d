"""Physical constants and unit conversions (the values of the JAX package's
``constants.py``)."""

TORR_2_PA = 133.322368421  # 1 Torr in Pa
AVOGADRO_CONSTANT = 6.02214076e23  # 1/mol
FUNDAMENTAL_CHARGE = 1.602176634e-19  # C
ELECTRON_MASS = 9.1093837015e-31  # kg
BOLTZMANN_CONSTANT = 1.380649e-23  # J/K
EPSILON_0 = 8.8541878128e-12  # F/m

# g/mol for common propellants
MOLECULAR_WEIGHTS = {
    "Xenon": 131.293,
    "Krypton": 83.798,
    "Argon": 39.948,
    "Bismuth": 208.98,
    "Mercury": 200.59,
}


def atomic_mass_kg(propellant: str) -> float:
    """Atomic mass of a propellant species in kg."""
    return MOLECULAR_WEIGHTS[propellant] / AVOGADRO_CONSTANT / 1000.0
