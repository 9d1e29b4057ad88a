"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality).

Attention-free SSM, 64L, d_model=2560, ssm_state=128, expand=2,
head_dim=64 (80 SSD heads), chunk 256, vocab=50280 (padded 50304), tied
embeddings.  The port trains it with the Seesaw ramp.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    max_seq_len=1_048_576,
    act="silu",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
