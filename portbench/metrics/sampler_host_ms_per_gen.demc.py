"""The sampler's own host ms a generation, from the program's spans (program_spans.sampler_host_ms_per_gen)."""
from portbench.program_spans import sampler_host_ms_per_gen as read  # noqa: F401
