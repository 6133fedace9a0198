"""The benchmark of fem_simulation_tpu_torch on an NVIDIA H100.

BENCHMARK.json at the root names its cells; `python3 -m fembench.run` runs
one (see run.py).
"""
