"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

MoE decoder, 32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=6400,
vocab=32064, 16 experts, top-2 routing.  Its weights alone are about
84 GB in bfloat16, more than one 80 GB card holds, so the port neither
trains nor serves it at full width; it runs the reduced shape
(``CONFIG.reduced()``), held to the reference on the CPU.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    max_seq_len=131072,
    rope_theta=10_000.0,
    act="silu",
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
