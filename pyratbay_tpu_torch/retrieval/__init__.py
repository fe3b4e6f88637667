"""Retrieval: parameter space, batched forward and log-posterior, the
DEMC sampler and the run driver."""
