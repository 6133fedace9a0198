"""The exp2 / exp3 drivers of the port, one module each, and the learning
path's profiler (`profile_learning`), run with
`python -m fem_simulation_tpu_torch.examples.<name>` (the GPU unless
`--device cpu`). Importing one runs nothing."""
