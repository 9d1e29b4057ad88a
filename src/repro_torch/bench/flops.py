"""The closed-form FLOPs and HBM bytes of a step, for every (arch ×
shape): ``benchmarks/flops_model.py`` in PyTorch's package, the same
functions and the same arithmetic, over the port's configs (whose
``param_count`` keeps the reference's formula).  ``step_flops``,
``forward_flops``, ``hbm_bytes`` and ``model_flops_per_token`` equal the
reference's exactly.

The reference needs them because XLA's CPU ``cost_analysis`` counts a
scanned layer once; the port's dry-run counts every layer
(``launch.dryrun``), and these give what a whole step should cost: the
work a step's share of the card's peak is taken against
(``bench.roofline``, ``chip_smoke.py`` phase 22).

Conventions (the reference's): one fused multiply-add = 2 FLOPs;
training = 3× forward (backward 2×) + 1× forward again when remat is on
⇒ 4× forward; causal-masked attention is charged the FULL S² (the
reference's XLA path computes the masked blocks) and S²/2 with
``block_skip``.
"""
from __future__ import annotations

from repro_torch.configs.base import (HybridConfig, InputShape,
                                      ModelConfig, SSMConfig)
from repro_torch.configs.base import _pattern as pattern_of


def _attn_layer_flops(cfg: ModelConfig, S_q: int, S_kv: int,
                      causal_half: bool = False) -> float:
    d = cfg.d_model
    proj = 2 * S_q * d * (cfg.q_dim + 2 * cfg.kv_dim) \
        + 2 * S_q * cfg.q_dim * d
    sc = 2 * S_q * S_kv * cfg.q_dim * 2          # QK^T and PV
    if causal_half:
        sc /= 2
    return proj + sc


def _mlp_flops(cfg: ModelConfig, S: int) -> float:
    n_mats = 3 if cfg.act == "silu" else 2
    return 2 * S * cfg.d_model * cfg.d_ff * n_mats


def _moe_layer_flops(cfg: ModelConfig, S: int) -> float:
    m = cfg.moe
    assert m is not None
    router = 2 * S * cfg.d_model * m.num_experts
    # capacity dispatch computes cf·k expert slots per token
    slots = S * m.top_k * m.capacity_factor
    expert = 2 * slots * cfg.d_model * m.d_expert * 3
    return router + expert


def _ssd_layer_flops(cfg: ModelConfig, S: int) -> float:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_ssm_heads(d)
    N, Pd, Q = s.d_state, s.head_dim, s.chunk_size
    proj = 2 * S * d * (2 * di + 2 * N + H) + 2 * S * di * d
    Qe = min(Q, S)
    # intra-chunk: CB (Q²N) + M@x (Q²P per head) ; states (QNP per head)
    intra = 2 * S * Qe * N + 2 * S * Qe * Pd * H
    states = 2 * S * N * Pd * H * 2              # build + apply
    return proj + intra + states


def _rglru_layer_flops(cfg: ModelConfig, S: int) -> float:
    h = cfg.hybrid or HybridConfig()
    w = h.lru_width or cfg.d_model
    d = cfg.d_model
    proj = 2 * S * d * w * 2 + 2 * S * w * d      # gate, x, out
    gates = 2 * S * w * w * 2                     # W_r, W_i
    return proj + gates


def _vocab_flops(cfg: ModelConfig, S: int) -> float:
    return 2 * S * cfg.d_model * cfg.padded_vocab


def forward_flops(cfg: ModelConfig, batch: int, seq: int, *,
                  mode: str = "train", block_skip: bool = False) -> float:
    """Total forward FLOPs (all devices) for one step of the workload."""
    S = batch * seq                                # total tokens
    L = cfg.n_layers
    half = block_skip
    if cfg.arch_type == "ssm":
        core = L * _ssd_layer_flops(cfg, S)
    elif cfg.arch_type == "hybrid":
        h = cfg.hybrid or HybridConfig()
        kinds = pattern_of(cfg, L)
        core = 0.0
        for kind in kinds:
            if kind == "recurrent":
                core += _rglru_layer_flops(cfg, S)
            else:
                skv = min(seq, h.local_window) if mode != "decode" else seq
                core += _attn_layer_flops(cfg, S, skv * 0 + min(
                    seq, h.local_window), causal_half=half)
            core += _mlp_flops(cfg, S)
    elif cfg.arch_type in ("encdec", "audio"):
        Se = batch * cfg.frontend_tokens
        St = S
        enc = cfg.n_encoder_layers * (
            _attn_layer_flops(cfg, Se, cfg.frontend_tokens)
            + _mlp_flops(cfg, Se))
        dec = L * (_attn_layer_flops(cfg, St, seq, causal_half=half)
                   + _attn_layer_flops(cfg, St, cfg.frontend_tokens)
                   + _mlp_flops(cfg, St))
        core = enc + dec
    elif cfg.arch_type == "moe":
        core = L * (_attn_layer_flops(cfg, S, seq, causal_half=half)
                    + _moe_layer_flops(cfg, S))
    else:
        skv = min(seq, cfg.sliding_window or seq)
        core = L * (_attn_layer_flops(cfg, S, skv, causal_half=half)
                    + _mlp_flops(cfg, S))
    return core + _vocab_flops(cfg, S if mode == "train" else batch)


def step_flops(cfg: ModelConfig, shape: InputShape, *,
               remat: bool = True, block_skip: bool = False) -> float:
    if shape.mode == "train":
        text = shape.seq_len
        f = forward_flops(cfg, shape.global_batch, text, mode="train",
                          block_skip=block_skip)
        return f * (4.0 if remat else 3.0)
    if shape.mode == "prefill":
        return forward_flops(cfg, shape.global_batch, shape.seq_len,
                             mode="prefill", block_skip=block_skip)
    # decode: one token against a seq_len cache/state
    if cfg.arch_type == "ssm":
        s = cfg.ssm or SSMConfig()
        d = cfg.d_model
        di = s.d_inner(d)
        H = s.n_ssm_heads(d)
        per_tok = cfg.n_layers * (
            2 * d * (2 * di + 2 * s.d_state + H) + 2 * di * d
            + 2 * H * s.head_dim * s.d_state * 2)
        return (per_tok + 2 * d * cfg.padded_vocab) * shape.global_batch
    kv = shape.seq_len
    if cfg.sliding_window:
        kv = min(kv, cfg.sliding_window)
    if cfg.arch_type == "hybrid":
        h = cfg.hybrid or HybridConfig()
        kinds = pattern_of(cfg, cfg.n_layers)
        w = h.lru_width or cfg.d_model
        per_tok = 0.0
        for kind in kinds:
            if kind == "recurrent":
                per_tok += 2 * cfg.d_model * w * 3 + 2 * w * w * 2
            else:
                per_tok += _attn_layer_flops(cfg, 1, min(shape.seq_len,
                                                         h.local_window))
            per_tok += _mlp_flops(cfg, 1)
        return (per_tok + 2 * cfg.d_model * cfg.padded_vocab) \
            * shape.global_batch
    per_tok = cfg.n_layers * (_attn_layer_flops(cfg, 1, kv)
                              + (_moe_layer_flops(cfg, 1)
                                 if cfg.arch_type == "moe"
                                 else _mlp_flops(cfg, 1)))
    if cfg.arch_type in ("encdec", "audio"):
        per_tok += cfg.n_layers * _attn_layer_flops(cfg, 1,
                                                    cfg.frontend_tokens)
    return (per_tok + 2 * cfg.d_model * cfg.padded_vocab) \
        * shape.global_batch


def model_flops_per_token(cfg: ModelConfig) -> float:
    """The 6·N(active)·D convention (per token, training)."""
    return 6.0 * cfg.active_param_count()


def hbm_bytes(cfg: ModelConfig, shape: InputShape, *, chips: int,
              remat: bool = True, n_params=None) -> float:
    """Per-device HBM traffic estimate for one step.

    Training: params+grads+opt-state read/write (f32 master, sharded
    over all chips) + bf16 weight all-gather destinations + saved
    activations write/read + O(10) residual-stream passes per layer.
    Serving: params read + cache read/write.

    ``n_params`` replaces ``cfg.param_count()`` (the reference's formula)
    by another count, such as the parameters the model holds
    (``bench.roofline``).
    """
    N = cfg.param_count() if n_params is None else n_params
    if shape.mode == "train":
        # f32 master params/opt: p rw, m rw, v rw, grads w — all sharded
        opt_traffic = N * 4 * 7 / chips
        # bf16 weights are all-gathered per layer: each device WRITES and
        # then READS a full bf16 copy per pass (fwd, bwd, +remat fwd)
        weight_traffic = N * 2 * 2 * (3 if remat else 2)
        tokens_local = shape.global_batch * shape.seq_len / chips
        act = tokens_local * cfg.d_model * 2              # one bf16 pass
        L = max(cfg.n_layers, 1)
        # ~10 residual-stream-sized reads/writes per layer per pass,
        # ×(fwd + bwd + remat-fwd)
        act_traffic = L * act * 10 * (3 if remat else 2)
        return opt_traffic + weight_traffic + act_traffic
    if shape.mode == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / chips
        act = tokens_local * cfg.d_model * 2
        L = max(cfg.n_layers, 1)
        return N * 2 * 2 + L * act * 10 + _cache_bytes(cfg, shape) / chips
    # decode: read the model once per token + touch the cache
    return N * 2 * 2 + _cache_bytes(cfg, shape) / chips * 2


def _cache_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    B, S = shape.global_batch, shape.seq_len
    if cfg.arch_type == "ssm":
        s = cfg.ssm or SSMConfig()
        H = s.n_ssm_heads(cfg.d_model)
        return cfg.n_layers * B * (H * s.head_dim * s.d_state * 4
                                   + (s.d_conv - 1)
                                   * (s.d_inner(cfg.d_model)
                                      + 2 * s.d_state) * 2)
    if cfg.arch_type == "hybrid":
        h = cfg.hybrid or HybridConfig()
        w = h.lru_width or cfg.d_model
        kinds = pattern_of(cfg, cfg.n_layers)
        tot = 0.0
        for kind in kinds:
            if kind == "recurrent":
                tot += B * (w * 4 + (h.conv1d_width - 1) * w * 2)
            else:
                tot += B * min(S, h.local_window) * cfg.kv_dim * 2 * 2
        return tot
    W = min(S, cfg.sliding_window or S)
    return cfg.n_layers * B * W * cfg.kv_dim * 2 * 2
