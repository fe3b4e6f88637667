"""The batched forward's host ms, from the program's spans (program_spans.forward_host_ms)."""
from portbench.program_spans import forward_host_ms as read  # noqa: F401
