"""Training: the loss's optimizer, data, checkpoints and loop (``repro.training``)."""
