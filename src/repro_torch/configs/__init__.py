"""Config registry: ``get_config('<arch-id>')`` for every architecture of
the reference — the paper's 150M/300M/600M presets, ``llama3.2-3b``
(for its GQA shapes), ``mistral-nemo-12b`` (dense, served at full
width and depth), ``yi-34b`` (dense, GQA groups of 7; too large for one
card), ``mamba2-2.7b`` (the SSM family, trained and served),
``recurrentgemma-9b`` (the RG-LRU hybrid, trained and served through
the blocking ``Server``), ``starcoder2-3b`` (a sliding window, served
through the dense ``Server``'s ring cache, and trained),
``granite-moe-1b-a400m`` (the MoE family, trained and served),
``phi3.5-moe-42b-a6.6b`` (MoE, too large for one card: its reduced
shape only), ``seamless-m4t-medium`` (the encoder-decoder, trained and
served through the ``Server``) and ``internvl2-76b`` (the VLM prefix on
a dense decoder; served at full width, cut in depth)."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (granite_moe_1b, internvl2_76b, llama3_2_3b,
                                 mamba2_2_7b, mistral_nemo_12b, phi3_5_moe,
                                 recurrentgemma_9b, seamless_m4t_medium,
                                 seesaw_paper, starcoder2_3b, yi_34b)
from repro_torch.configs.base import (INPUT_SHAPES, HybridConfig,
                                      InputShape, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      ScheduleConfig, SSMConfig)

_CONFIGS = {
    "seesaw-150m": seesaw_paper.SEESAW_150M,
    "seesaw-300m": seesaw_paper.SEESAW_300M,
    "seesaw-600m": seesaw_paper.SEESAW_600M,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "yi-34b": yi_34b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
}


# the reference's assigned architectures, in its order (the dry-run's --all)
ASSIGNED_ARCHS: List[str] = [
    "mistral-nemo-12b", "llama3.2-3b", "seamless-m4t-medium",
    "recurrentgemma-9b", "yi-34b", "phi3.5-moe-42b-a6.6b",
    "granite-moe-1b-a400m", "internvl2-76b", "mamba2-2.7b", "starcoder2-3b"]


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


def list_archs() -> List[str]:
    return list(_CONFIGS)


__all__ = ["ASSIGNED_ARCHS", "INPUT_SHAPES", "HybridConfig", "InputShape",
           "ModelConfig", "MoEConfig", "OptimizerConfig", "RunConfig",
           "SSMConfig", "ScheduleConfig", "get_config", "list_archs"]
