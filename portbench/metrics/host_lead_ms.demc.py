"""The host's lead over the card at a forward's start (program_spans.host_lead_ms)."""
from portbench.program_spans import host_lead_ms as read  # noqa: F401
