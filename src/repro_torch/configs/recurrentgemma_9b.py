"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

Hybrid: RG-LRU recurrent blocks + local attention, 1 attention : 2
recurrent pattern, 38L, d_model=4096, 16 heads (MQA kv=1, head_dim=256),
d_ff=12288, vocab=256000, local window 2048.  The port trains it
(``models.rglru``) and serves it through the blocking ``Server``: each
attention layer decodes from a ring of min(2048, max_len) slots, each
recurrent layer from its O(1) state.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    max_seq_len=1_048_576,      # unbounded in principle; state is O(1)
    rope_theta=10_000.0,
    act="gelu",
    hybrid=HybridConfig(
        pattern=("recurrent", "recurrent", "attention"),
        lru_width=4096,
        local_window=2048,
        conv1d_width=4,
    ),
    source="arXiv:2402.19427",
)
