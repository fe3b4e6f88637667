"""The sampler's own ms a generation (readers.sampler_ms_per_gen)."""
from portbench.readers import sampler_ms_per_gen as read  # noqa: F401
