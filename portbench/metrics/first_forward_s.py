"""Set-up's first batched forward, from the program's spans (program_spans.first_forward_s)."""
from portbench.program_spans import first_forward_s as read  # noqa: F401
