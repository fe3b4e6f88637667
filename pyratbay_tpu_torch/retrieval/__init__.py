"""Retrieval: parameter space, batched forward and log-posterior, the
DEMC sampler and the run driver."""
from .params import RetrievalParams
from .forward import build_forward, build_log_posterior
from .samplers import sample_demc, gelman_rubin
from .posterior import (
    weighted_to_equal,
    marginal_statistics,
    temperature_posterior,
    spectrum_posterior,
)
