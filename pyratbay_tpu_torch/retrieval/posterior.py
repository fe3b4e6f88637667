"""Posterior post-processing: weighting, quantiles, and the temperature
and spectrum credible envelopes.

Port of pyratbay_tpu/retrieval/posterior.py: the two envelopes evaluate
their draws in one batched call each (the T(p) model on [n, npars], the
batched forward at B = number of draws) where the reference vmaps.
"""
import numpy as np
import torch

from ..tracing import to_host

__all__ = [
    'weighted_to_equal',
    'marginal_statistics',
    'temperature_posterior',
    'spectrum_posterior',
]

_PERCENTILES = [50.0, 15.865, 84.135, 2.275, 97.725]


def weighted_to_equal(samples, weights, rng=None):
    """Convert weighted posterior samples to equally-weighted ones by
    multinomial resampling (the nested-sampling -> MCMC-style
    conversion)."""
    if rng is None:
        rng = np.random.default_rng(0)
    weights = np.asarray(weights, float)
    weights = weights / np.sum(weights)
    n = len(weights)
    idx = rng.choice(n, size=n, p=weights)
    return np.asarray(samples)[idx]


def marginal_statistics(posterior, quantiles=(0.159, 0.5, 0.841)):
    """Per-parameter marginal quantiles; returns [nquant, npars]."""
    posterior = np.atleast_2d(np.asarray(posterior))
    return np.quantile(posterior, quantiles, axis=0)


def _envelopes(values):
    """(median, low1, high1, low2, high2) over the first axis."""
    return tuple(np.percentile(values, _PERCENTILES, axis=0))


def temperature_posterior(posterior, temp_model):
    """Median and 68%/95% interquantile envelopes of T(p) profiles.

    posterior: [nsamples, npars] temperature-parameter draws;
    temp_model: params [n, npars] tensor -> T [n, nlayers] tensor,
    called once on the unique draws.  Returns (median, low1, high1,
    low2, high2).
    """
    posterior = np.asarray(posterior)
    uniq, inverse = np.unique(posterior, axis=0, return_inverse=True)
    profiles = to_host(temp_model(uniq)).double().numpy()
    return _envelopes(profiles[inverse.reshape(-1)])


def spectrum_posterior(posterior, forward_b, max_draws=512, rng=None):
    """Credible envelopes of the model spectrum over posterior draws.

    forward_b: params [B, npars] -> spectra [B, W], called once on at
    most max_draws draws (chosen as pyratbay_tpu chooses them).
    Returns (median, low1, high1, low2, high2) spectra.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    posterior = np.asarray(posterior)
    n = len(posterior)
    if n > max_draws:
        posterior = posterior[rng.choice(n, max_draws, replace=False)]
    with torch.no_grad():
        spectra = forward_b(posterior)
    return _envelopes(to_host(spectra).double().numpy())
