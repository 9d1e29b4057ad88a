"""The Seesaw plan and its LR schedules (``repro.core`` in PyTorch)."""
