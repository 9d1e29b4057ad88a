"""Yi-34B [arXiv:2403.04652].

Llama-architecture dense decoder, 60 layers, d_model=7168, 56 heads
(GQA kv=8: a group of 7, head_dim 128), d_ff=20480, vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    max_seq_len=32768,
    rope_theta=5_000_000.0,
    act="silu",
    source="arXiv:2403.04652",
)
