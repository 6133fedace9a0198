"""A/B harnesses of the solver studies (compare.py)."""
