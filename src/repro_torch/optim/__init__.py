"""Optimizers (``repro.optim`` in PyTorch)."""
