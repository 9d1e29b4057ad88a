"""StarCoder2-3B [arXiv:2402.19173].

Dense decoder, 30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288,
vocab=49152, RoPE, GeLU, untied embeddings, and a native 4096-token
sliding window: its decode cache is a ring of 4096 slots a layer,
whatever the length served.  The port serves it through the dense
``Server``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    max_seq_len=1_048_576,
    rope_theta=999_999.4,
    sliding_window=4096,
    act="gelu",
    source="arXiv:2402.19173",
)
