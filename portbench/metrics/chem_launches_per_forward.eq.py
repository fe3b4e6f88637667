"""Device launches inside the equilibrium solve a forward, from the device trace (readers_chem.chem_launches_per_forward)."""
from portbench.readers_chem import chem_launches_per_forward as read  # noqa: F401
