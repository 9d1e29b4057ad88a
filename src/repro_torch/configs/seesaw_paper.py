"""The paper's own model presets (§4): 150M / 300M / 600M non-embedding
parameters, OLMo-style, trained at Chinchilla scale on C4 with the T5
tokenizer (vocab 32128), seq len 1024.

Architecture tuples (depth, heads, width): 150M (12,16,1024),
300M (24,16,1024), 600M (24,22,1408).  CBS per §4: 256k / 512k / 1024k
tokens, i.e. B* = 256 / 512 / 1024 sequences at L=1024.
"""
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ScheduleConfig)


def _olmo_like(name: str, depth: int, heads: int, width: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        arch_type="dense",
        n_layers=depth,
        d_model=width,
        n_heads=heads,
        n_kv_heads=heads,           # MHA at these scales
        head_dim=width // heads,
        d_ff=4 * width,
        vocab_size=32128,           # T5 tokenizer
        max_seq_len=1024,
        rope_theta=10_000.0,
        act="silu",
        source="Seesaw paper §4 (OLMo codebase)",
    )


SEESAW_150M = _olmo_like("seesaw-150m", 12, 16, 1024)
SEESAW_300M = _olmo_like("seesaw-300m", 24, 16, 1024)
SEESAW_600M = _olmo_like("seesaw-600m", 24, 22, 1408)

# Critical batch sizes from §4 (in sequences at L=1024).
CBS = {"seesaw-150m": 256, "seesaw-300m": 512, "seesaw-600m": 1024}

CONFIG = SEESAW_150M


def paper_run(model: ModelConfig, *, kind: str = "seesaw",
              batch_size: int | None = None, lr: float = 3e-3,
              alpha: float = 2.0) -> RunConfig:
    """A RunConfig matching the paper's §4 protocol: AdamW(0.9, 0.95),
    10% warmup, seq 1024, B0 = the model's critical batch size."""
    bs = batch_size or CBS.get(model.name, 256)
    beta = alpha if kind == "seesaw" else 1.0
    return RunConfig(
        model=model,
        schedule=ScheduleConfig(kind=kind, base_lr=lr, warmup_frac=0.10,
                                alpha=alpha, beta=beta),
        optimizer=OptimizerConfig(kind="adamw", beta1=0.9, beta2=0.95,
                                  eps=1e-8, weight_decay=0.0),
        seq_len=1024,
        global_batch_size=bs,
        z_loss=0.0,
    )
