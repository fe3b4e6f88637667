"""Device launches of one batched forward (readers.launches_per_call)."""
from portbench.readers import launches_per_call as read  # noqa: F401
