"""The batched forward's ms by CUDA events at the ensemble's batch (readers.forward_ms)."""
from portbench.readers import forward_ms as read  # noqa: F401
