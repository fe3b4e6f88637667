"""Atmospheric structure: pressure/temperature profiles, free VMR
models, hydrostatic radii and transit geometry, as functions of
tensors whose leading dimension is the chain ensemble."""
