"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

MoE decoder, 24L, d_model=1024, 16 heads (GQA kv=8), expert d_ff=512,
vocab=49155 (padded 49280), 32 experts, top-8 routing, tied
embeddings: 1.33B parameters, about 0.4B active a token.  The port
trains and serves it at full width on one card.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    max_seq_len=4096,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
