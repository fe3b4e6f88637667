"""The solve kernel's share of its float64 roofline (readers_chem.chem_roofline_share)."""
from portbench.readers_chem import chem_roofline_share as read  # noqa: F401
