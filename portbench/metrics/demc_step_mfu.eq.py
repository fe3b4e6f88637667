"""The DEMC step's share of the card's float32 and float64 peaks (readers_chem.demc_step_mfu_eq)."""
from portbench.readers_chem import demc_step_mfu_eq as read  # noqa: F401
