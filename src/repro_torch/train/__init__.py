"""The training engine and trainer (``repro.train`` in PyTorch)."""
