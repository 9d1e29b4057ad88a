"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family card].

Dense decoder, 28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192,
vocab=128256, RoPE theta=500k, tied embeddings.  The port serves it for
its GQA head shapes (H=24, Hkv=8, head_dim 128).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    max_seq_len=131072,
    rope_theta=500_000.0,
    tie_embeddings=True,
    act="silu",
    source="hf:meta-llama/Llama-3.2-1B",
)
