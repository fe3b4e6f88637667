"""The equilibrium solve's device ms a forward, from the program's spans (readers_chem.chem_device_ms)."""
from portbench.readers_chem import chem_device_ms as read  # noqa: F401
