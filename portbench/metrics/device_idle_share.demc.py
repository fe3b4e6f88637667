"""The card's idle share in the profiled DEMC chunk (readers.device_idle_share)."""
from portbench.readers import device_idle_share as read  # noqa: F401
