"""Model config: a frozen dataclass per architecture.

This package's own copy of ``repro.configs.base.ModelConfig`` (the port
imports nothing of the JAX package).  The fields, ``padded_vocab``,
``param_count`` and ``reduced()`` are the reference's; there is no
``kernel_backend`` field, because the port picks the kernel by the
device a tensor lies on (see ``repro_torch.kernels.backend``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block hyperparameters (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid (arXiv:2402.19427)."""
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    lru_width: Optional[int] = None      # defaults to d_model
    local_window: int = 2048
    conv1d_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str        # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int                # logical vocabulary
    head_dim: Optional[int] = None
    max_seq_len: int = 131072
    rope_theta: float = 500000.0
    sliding_window: Optional[int] = None     # None = full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"              # silu (SwiGLU) | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    n_encoder_layers: int = 0      # encdec only
    frontend_tokens: int = 0       # patches/frames from the stub frontend
    frontend_dim: Optional[int] = None
    source: str = ""               # citation

    def __post_init__(self):
        if self.head_dim is None and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (the reference's embedding
        layout; the port keeps it so weights load one to one)."""
        return _round_up(self.vocab_size, 128)

    @property
    def q_dim(self) -> int:
        return self.n_heads * (self.head_dim or 0)

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * (self.head_dim or 0)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included, logical vocab)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.arch_type == "ssm":
            s = self.ssm or SSMConfig()
            di = s.d_inner(d)
            nh = s.n_ssm_heads(d)
            per_layer = d * (2 * di + 2 * s.d_state + nh) + di * d \
                + s.d_conv * (di + 2 * s.d_state) + 2 * nh + 2 * d
            return emb + L * per_layer
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = (3 if self.act == "silu" else 2) * d * self.d_ff
        norms = 2 * d
        if self.arch_type == "moe":
            m = self.moe
            assert m is not None
            ff = m.num_experts * 3 * d * m.d_expert + d * m.num_experts
            per_layer = attn + ff + norms
        elif self.arch_type == "hybrid":
            h = self.hybrid or HybridConfig()
            w = h.lru_width or d
            rec = d * w * 2 + w * d + 2 * w + h.conv1d_width * w
            n_rec = sum(1 for p in _pattern(self, L) if p == "recurrent")
            n_att = L - n_rec
            total = n_att * (attn + mlp + norms) + n_rec * (rec + mlp + norms)
            return emb + total
        else:
            per_layer = attn + mlp + norms
        total = L * per_layer
        if self.arch_type == "encdec":
            total += self.n_encoder_layers * (attn + mlp + norms) + L * attn
        return emb + total

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=512,
            vocab_size=512,
            head_dim=64,
            max_seq_len=4096,
        )
        if self.arch_type == "moe":
            assert self.moe is not None
            kw["moe"] = replace(self.moe, num_experts=4,
                                top_k=min(self.moe.top_k, 2), d_expert=128)
        if self.arch_type == "ssm":
            kw["ssm"] = replace(self.ssm or SSMConfig(), d_state=16,
                                head_dim=64, chunk_size=32)
            kw["n_heads"] = 0
            kw["n_kv_heads"] = 0
        if self.arch_type == "hybrid":
            kw["hybrid"] = replace(self.hybrid or HybridConfig(),
                                   lru_width=256, local_window=64)
        if self.arch_type == "encdec":
            kw["n_encoder_layers"] = 2
        if self.arch_type in ("vlm", "audio", "encdec"):
            kw["frontend_tokens"] = 16
            kw["frontend_dim"] = 256
        if self.sliding_window is not None:
            kw["sliding_window"] = 64
        return replace(self, **kw)


def _pattern(cfg: ModelConfig, n_layers: int) -> Tuple[str, ...]:
    h = cfg.hybrid or HybridConfig()
    reps = math.ceil(n_layers / len(h.pattern))
    return tuple((h.pattern * reps)[:n_layers])
