"""The paper's own model presets (§4): 150M / 300M / 600M non-embedding
parameters, OLMo-style, trained at Chinchilla scale on C4 with the T5
tokenizer (vocab 32128), seq len 1024.

Architecture tuples (depth, heads, width): 150M (12,16,1024),
300M (24,16,1024), 600M (24,22,1408).
"""
from repro_torch.configs.base import ModelConfig


def _olmo_like(name: str, depth: int, heads: int, width: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        arch_type="dense",
        n_layers=depth,
        d_model=width,
        n_heads=heads,
        n_kv_heads=heads,           # MHA at these scales
        head_dim=width // heads,
        d_ff=4 * width,
        vocab_size=32128,           # T5 tokenizer
        max_seq_len=1024,
        rope_theta=10_000.0,
        act="silu",
        source="Seesaw paper §4 (OLMo codebase)",
    )


SEESAW_150M = _olmo_like("seesaw-150m", 12, 16, 1024)
SEESAW_300M = _olmo_like("seesaw-300m", 24, 16, 1024)
SEESAW_600M = _olmo_like("seesaw-600m", 24, 22, 1408)

CONFIG = SEESAW_150M
