"""Opacity sources of the transit slice: line-sampled cross sections,
CIA, alkali (van der Waals) lines, and clouds (deck, Lecavelier haze).

Setup is host-side numpy (mirroring pyratbay_tpu.opacity); `to(device,
dtype)` materializes the static tables as tensors for the forward.
"""
