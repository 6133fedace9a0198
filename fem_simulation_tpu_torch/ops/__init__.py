"""Lattice operators: plain torch versions and the CUDA kernel wrappers."""
