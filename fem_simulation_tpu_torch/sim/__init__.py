"""Structured-lattice dynamic simulation."""
