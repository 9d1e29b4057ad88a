"""Synthetic data and the phase-aware loader (``repro.data`` in
PyTorch)."""
from repro_torch.data.pipeline import PhaseDataLoader, validate_per_host_plan
from repro_torch.data.synthetic import LinearRegressionSampler, MarkovLM

__all__ = ["LinearRegressionSampler", "MarkovLM", "PhaseDataLoader",
           "validate_per_host_plan"]
