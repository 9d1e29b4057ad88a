"""Mistral-NeMo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder, 40 layers, d_model=5120, 32 heads (GQA kv=8, head_dim
128, so q_dim 4096 is narrower than d_model), d_ff=14336, vocab=131072
(Tekken), 128k context, RoPE theta=1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    max_seq_len=131072,
    rope_theta=1_000_000.0,
    act="silu",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
