"""Config registry: ``get_config('<arch-id>')`` for the architectures the
port runs so far — the paper's 150M/300M/600M presets, ``llama3.2-3b``
(for its GQA shapes), ``mamba2-2.7b`` (the SSM family, trained and
served), ``starcoder2-3b`` (a sliding window, served through the
dense ``Server``'s ring cache), ``granite-moe-1b-a400m`` (the MoE
family, trained and served) and ``phi3.5-moe-42b-a6.6b`` (MoE, too
large for one card: its reduced shape only)."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (granite_moe_1b, llama3_2_3b, mamba2_2_7b,
                                 phi3_5_moe, seesaw_paper, starcoder2_3b)
from repro_torch.configs.base import (HybridConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      ScheduleConfig, SSMConfig)

_CONFIGS = {
    "seesaw-150m": seesaw_paper.SEESAW_150M,
    "seesaw-300m": seesaw_paper.SEESAW_300M,
    "seesaw-600m": seesaw_paper.SEESAW_600M,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe.CONFIG,
}


# the reference's archs of families the port does not run yet
_LATER = {
    "recurrentgemma-9b": "the other-families slice (RG-LRU hybrid)",
    "seamless-m4t-medium": "the other-families slice (enc-dec audio)",
    "internvl2-76b": "the other-families slice (VLM prefix)",
}


def get_config(name: str) -> ModelConfig:
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; it comes with "
            f"{_LATER[name]}")
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


def list_archs() -> List[str]:
    return list(_CONFIGS)


__all__ = ["HybridConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "RunConfig", "SSMConfig", "ScheduleConfig", "get_config",
           "list_archs"]
