"""InternVL2-Llama3-76B language backbone [arXiv:2404.16821].

A vision-language model: the InternViT-6B encoder and its MLP projector
are a stub, as in the reference (the model takes projected patch
embeddings, 1024 a image, ahead of the text), feeding a
Llama-3-70B-class decoder: 80 layers, d_model=8192, 64 heads (GQA
kv=8, head_dim 128), d_ff=28672, vocab=128256, untied head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    max_seq_len=32768,
    rope_theta=500_000.0,
    act="silu",
    frontend_tokens=1024,       # ViT patches per image after the projector
    frontend_dim=8192,
    source="arXiv:2404.16821",
)
