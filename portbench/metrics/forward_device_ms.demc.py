"""The batched forward's device ms, from the program's spans (program_spans.forward_device_ms)."""
from portbench.program_spans import forward_device_ms as read  # noqa: F401
