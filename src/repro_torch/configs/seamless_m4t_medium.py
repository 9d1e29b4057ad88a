"""SeamlessM4T-medium text backbone [arXiv:2308.11596].

Encoder-decoder transformer, 12 layers each, d_model=1024, 16 heads
(MHA, head_dim 64), GeLU d_ff=4096, vocab=256206 (padded to 256256).
The speech frontend (mel filter bank and the w2v-BERT conv feature
extractor) is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, 1024 frames, 1024).

``param_count`` is the reference's formula, which adds the encoder and
the cross-attention only for ``arch_type == "encdec"``: it counts
675,729,408 parameters where the model holds 877,197,312.  ``reduced``
keeps all 12 encoder layers for the same reason.  The port keeps both,
so plans and token budgets equal the reference's.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,                # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    max_seq_len=32768,
    rope_theta=10_000.0,
    act="gelu",
    frontend_tokens=1024,       # audio frames consumed per example
    frontend_dim=1024,
    source="arXiv:2308.11596",
)
