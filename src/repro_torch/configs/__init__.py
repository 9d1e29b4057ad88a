"""Config registry: ``get_config('<arch-id>')`` for the architectures the
port serves so far — the paper's 150M/300M/600M presets and
``llama3.2-3b`` (for its GQA shapes)."""
from __future__ import annotations

from typing import List

from repro_torch.configs import llama3_2_3b, seesaw_paper
from repro_torch.configs.base import (HybridConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      ScheduleConfig, SSMConfig)

_CONFIGS = {
    "seesaw-150m": seesaw_paper.SEESAW_150M,
    "seesaw-300m": seesaw_paper.SEESAW_300M,
    "seesaw-600m": seesaw_paper.SEESAW_600M,
    "llama3.2-3b": llama3_2_3b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


def list_archs() -> List[str]:
    return list(_CONFIGS)


__all__ = ["HybridConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "RunConfig", "SSMConfig", "ScheduleConfig", "get_config",
           "list_archs"]
