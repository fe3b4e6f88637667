"""Opacity sources: line-sampled cross sections, CIA, alkali (van der
Waals) lines, Rayleigh scattering, H- bound-free/free-free, clouds
(deck, gray, Lecavelier haze), and the line-by-line engine of the
opacity tables.

Setup is host-side numpy (mirroring pyratbay_tpu.opacity); `to(device,
dtype)` materializes the static tables as tensors for the forward.
"""
from .rayleigh import Rayleigh
from .clouds import Lecavelier, CCSgray, Deck
from .h_ion import HydrogenIon
from .alkali import SodiumVdW, PotassiumVdW, get_alkali_model
from .cia import CIA
from .line_sample import LineSample
