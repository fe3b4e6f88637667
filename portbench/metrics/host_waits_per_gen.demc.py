"""The host's waits on the card a DEMC generation (program_spans.host_waits_per_gen)."""
from portbench.program_spans import host_waits_per_gen as read  # noqa: F401
