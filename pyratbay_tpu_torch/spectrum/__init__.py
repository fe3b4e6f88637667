"""Spectra: the per-chain transit RT reference, tophat passbands, and
the ensemble transit kernel (transit_kernel.py)."""
