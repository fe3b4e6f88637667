"""The DEMC step's share of the card's peak (readers.demc_step_mfu)."""
from portbench.readers import demc_step_mfu as read  # noqa: F401
