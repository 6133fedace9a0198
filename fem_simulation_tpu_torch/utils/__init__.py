"""Host utilities: visualization, checkpoints, invariant checks, timing."""
