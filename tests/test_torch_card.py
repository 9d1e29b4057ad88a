"""The hand-written CUDA kernels on the card, each against its plain
version, and the serving engine and one training step on the card
against the same on the CPU.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine as it is:

    python -m pytest -m gpu tests/test_torch_card.py

Tolerances: 2e-5 in float32 (sums in another order), 2e-2 in bfloat16
(one rounding of the output), TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine

pytestmark = pytest.mark.gpu

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = BF16 if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024), (1, 1000, 1024), (37, 64),
                                   (3, 3072)])
def test_rmsnorm_kernel(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    s = 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    got = RN.rmsnorm_fwd(x, s, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, ref.rmsnorm_ref(x, s, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 16, 16, 1024, 64),      # seesaw-150m prefill
    (1, 24, 8, 1000, 128),      # llama3.2-3b heads, ragged tail
    (2, 4, 2, 77, 64),
    (1, 2, 1, 1, 128),
])
def test_flash_fwd_kernel(cuda, B, H, Hkv, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    # the models' (B, S, H, hd) layout, read as transposed views
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out, lse = FA.flash_fwd(qt, kt, vt)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref(qt, kt, vt)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Skv,hd", [
    (8, 16, 16, 1024, 64),      # seesaw-150m decode, 8 slots
    (8, 24, 8, 1000, 128),      # llama3.2-3b heads
    (3, 4, 1, 20, 64),
])
def test_ragged_decode_kernel(cuda, B, H, Hkv, Skv, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dtype)
    # a gathered head-interleaved window, split into strided K/V views
    kv = torch.randn(B, Skv, 2 * Hkv, hd, generator=g, device=cuda).to(dtype)
    k, v = kv[:, :, 0::2], kv[:, :, 1::2]
    lengths = torch.randint(0, Skv, (B,), generator=g, device=cuda,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 0, Skv - 1
    got = KB.paged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    want = ref.ragged_decode_ref(q[:, 0], k.transpose(1, 2),
                                 v.transpose(1, 2), lengths)
    _close(got[:, 0], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 1024, 1024), (1000, 3072), (37, 64),
                                   (3, 5, 256)])
def test_rmsnorm_bwd_kernel(cuda, shape, dtype):
    g_ = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g_, device=cuda).to(dtype)
    s = 0.1 * torch.randn(shape[-1], generator=g_, device=cuda)
    g = torch.randn(shape, generator=g_, device=cuda).to(dtype)
    dx, ds = RN.rmsnorm_bwd(x, s, g, 1e-5)
    torch.cuda.synchronize()
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, g, 1e-5)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    _close(dx, want_dx, dtype)
    # dscale is a float32 sum over every row, taken in another order: its
    # error is held to 2e-5 of the sum of the terms' magnitudes
    x32 = x.float().reshape(-1, shape[-1])
    xh = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5)
    mag = (g.float().reshape(-1, shape[-1]) * xh).abs().sum(0)
    assert bool(((ds - want_ds).abs() <= 2e-5 * mag + 1e-6).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (8, 16, 16, 1024, 64),      # seesaw-150m training
    (1, 24, 8, 1000, 128),      # llama3.2-3b heads, ragged tail
    (2, 4, 2, 77, 64),
    (1, 4, 1, 33, 128),
])
def test_flash_bwd_kernels(cuda, B, H, Hkv, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse = FA.flash_fwd(qt, kt, vt)
    got = FA.flash_bwd(qt, kt, vt, out, lse, dot)
    torch.cuda.synchronize()
    want = ref.flash_bwd_ref(qt, kt, vt, out, lse, dot)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, dtype)


def test_autograd_on_card_launches_the_backward_kernels(cuda):
    """backend.rmsnorm and backend.attention on CUDA tensors: the
    gradients come from the backward kernels (counted) and equal those
    of autograd through the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 40, 64, generator=g, device=cuda, requires_grad=True)
    s = torch.zeros(64, device=cuda, requires_grad=True)
    q = torch.randn(2, 40, 4, 64, generator=g, device=cuda,
                    requires_grad=True)
    k = torch.randn(2, 40, 2, 64, generator=g, device=cuda,
                    requires_grad=True)
    before = (RN.bwd_launches, FA.dq_launches, FA.dkv_launches)
    y = KB.rmsnorm(x, s).square().sum() + KB.attention(q, k, k).sum()
    got = torch.autograd.grad(y, (x, s, q, k))
    assert (RN.bwd_launches, FA.dq_launches, FA.dkv_launches) == \
        tuple(c + 1 for c in before)
    out, _ = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               k.transpose(1, 2))
    y2 = ref.rmsnorm_ref(x, s).square().sum() + out.sum()
    for a, b in zip(got, torch.autograd.grad(y2, (x, s, q, k))):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """One loss and its grads on the card (kernels) against the CPU
    (plain versions), float32, same weights; then AdamW applied on each
    device to the same grads at a fixed LR."""
    from repro_torch.optim import optimizers as O
    cfg = ModelConfig(name="card-train", arch_type="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=300, max_seq_len=64,
                      rope_theta=1e4)
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 300, (2, 49))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, z_loss=1e-4, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())
    params = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        opt = O.adamw()
        p = dict(model.named_parameters())
        grads = {n: g.to(dev) for n, g in zip(p, out["cpu"][1])}
        opt.update(grads, opt.init(p), p, torch.tensor(1e-3))
        params[dev] = [t.detach().cpu() for t in p.values()]
    for a, b in zip(params["cpu"], params["cuda"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_rmsnorm_zero_rows_launches_nothing(cuda):
    before = RN.launches
    got = RN.rmsnorm_fwd(torch.zeros(0, 64, device=cuda),
                         torch.zeros(64, device=cuda))
    assert got.shape == (0, 64) and RN.launches == before


def test_wrappers_raise_on_unsupported(cuda):
    q = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(q, q, q)
    x = torch.zeros(2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RN.rmsnorm_fwd(x, torch.zeros(64, device=cuda))


def test_engine_on_card_matches_cpu(cuda):
    """The engine on the card (kernels) against the same engine on the
    CPU (plain versions), float32, head_dim 64 so the kernels take it."""
    cfg = ModelConfig(name="card-tiny", arch_type="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=256, max_seq_len=64,
                      rope_theta=1e4)
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = R.init_model(cfg, seed=0, dtype=torch.float32,
                        device="cpu").to(cuda)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 256, (s,)).astype(np.int32), n)
            for s, n in zip((3, 9, 17, 5, 12), (6, 4, 8, 10, 5))]
    outs = []
    for model in (cpu, card):
        eng = ServingEngine(cfg, model, dtype=torch.float32,
                            decode_slots=2, page_size=4, max_len=32)
        for p, n in reqs:
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=n))
        outs.append({r.rid: r.tokens for r in eng.drain()})
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
