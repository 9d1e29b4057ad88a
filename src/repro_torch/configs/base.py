"""Model and run configs: frozen dataclasses.

This package's own copy of ``repro.configs.base`` (the port imports
nothing of the JAX package): ``ModelConfig`` with the reference's
fields, ``padded_vocab``, ``param_count`` and ``reduced()``, and the
training run's ``ScheduleConfig``, ``OptimizerConfig`` and
``RunConfig``.  There is no ``kernel_backend`` field anywhere, because
the port picks the kernel by the device a tensor lies on (see
``repro_torch.kernels.backend``).
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

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k experts only)."""
        if self.arch_type != "moe":
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ff = m.top_k * 3 * d * m.d_expert + d * m.num_experts
        return emb + L * (attn + ff + 2 * d)

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


@dataclass(frozen=True)
class ScheduleConfig:
    """LR×batch schedule — the paper's contribution lives here."""
    # cosine | step | seesaw | seesaw-general | constant | naive-ramp
    # | adaptive-seesaw
    kind: str = "cosine"
    base_lr: float = 3e-3
    warmup_frac: float = 0.10      # paper: warmup for 10% of tokens
    alpha: float = 2.0             # step-decay factor of the reference
    beta: float = 1.0              # batch multiplier per cut
    n_cuts: int = 8                # step-decay approximation depth of cosine;
    #                                adaptive-seesaw: most cuts the controller
    #                                may fire (sizes the LR table)
    final_lr_frac: float = 0.0
    max_batch_size: Optional[int] = None   # hardware cap on the ramp
    # adaptive-seesaw controller knobs (ignored by every other kind)
    ema_decay: float = 0.98        # loss-EMA decay per step
    plateau_window: int = 50       # steps per plateau test
    plateau_threshold: float = 2e-3  # relative improvement floor
    plateau_min_steps: Optional[int] = None  # min steps between cuts
    #                                          (None: plateau_window)


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # adamw | adam | sgd | nsgd
    beta1: float = 0.9             # paper §4
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0      # paper default λ=0
    grad_clip: float = 1.0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    schedule: ScheduleConfig
    optimizer: OptimizerConfig
    seq_len: int = 1024
    global_batch_size: int = 256   # B0 — sequences per step
    total_tokens: int = 0          # 0 ⇒ Chinchilla D = 20·N
    z_loss: float = 0.0
    seed: int = 0
    dtype: str = "bfloat16"        # compute dtype; params/opt state f32
    remat: bool = True
    log_every: int = 10

    def resolved_total_tokens(self) -> int:
        if self.total_tokens:
            return self.total_tokens
        return 20 * self.model.param_count()


@dataclass(frozen=True)
class InputShape:
    """One workload shape of the reference's assignment."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    # Seesaw phase-k batch sizes (B0 = 256 doubled per phase)
    "train_4k_b512":  InputShape("train_4k_b512",  4_096,  512, "train"),
    "train_4k_b1024": InputShape("train_4k_b1024", 4_096, 1024, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
