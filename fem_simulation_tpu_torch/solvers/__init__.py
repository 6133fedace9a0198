"""Solver control of the lattice step."""
