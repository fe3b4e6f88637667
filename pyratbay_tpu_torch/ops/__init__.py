"""Numerical primitives: spectral grids (numpy), special functions,
interpolation and integration on tensors."""
