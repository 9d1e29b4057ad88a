"""The hand-written CUDA kernels on the card, each against its plain
version, and the serving engine and one training step of the dense
model and of Mamba-2 on the card against the same on the CPU.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine as it is:

    python -m pytest -m gpu tests/test_torch_card.py

Tolerances: 2e-5 in float32 (sums in another order), 2e-2 in bfloat16
(one rounding of the output), TF32 off.  The SSD chunk kernel at
mamba2-2.7b's decay (A down to -80, Q = 256: cum reaches ~-2000 within
a chunk, where float32 sums of it differ by ~1e-4 relative) is held to
a float64 evaluation of its plain version instead: its error must not
exceed twice the float32 plain version's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
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
                                   (3, 3072), (2, 512, 2560),
                                   (2, 512, 5120)])
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
                                   (3, 5, 256), (4, 2048, 2560),
                                   (4, 2048, 5120)])
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


def _ssd_inputs(cuda, B, S, H, P, N, dtype, seed, mamba_decay):
    """x, B, C as views of one (B, S, H·P + 2N) tensor, as the mixer
    hands them to the kernel.  ``mamba_decay``: mamba2-2.7b's init
    (A = -(1..H), dt around its log-spaced [1e-3, 1e-1]); else the
    reference's kernel tests' small decays."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    di = H * P
    xbc = torch.randn(B, S, di + 2 * N, generator=g, device=cuda).to(dtype)
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    if mamba_decay:
        lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
        dt0 = torch.exp(torch.linspace(float(lo), float(hi), H,
                                       device=cuda))
        bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = torch.nn.functional.softplus(
            bias + 0.5 * torch.randn(B, S, H, generator=g, device=cuda))
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, H, generator=g, device=cuda))
        A = -torch.exp(0.3 * torch.randn(H, generator=g, device=cuda))
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 96, 4, 32, 16, 32),     # tests/test_kernels.py::TestSSD
    (1, 128, 2, 64, 32, 64),
    (2, 100, 3, 16, 8, 32),     # ragged S
    (2, 64, 8, 64, 16, 32),     # the reduced mamba2
])
def test_ssd_chunk_kernel(cuda, B, S, H, P, N, Q, dtype):
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, dtype, 8, False)
    got = SSD.ssd_chunk(xh, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    want = ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, Q)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,H,mamba_decay", [
    (2048, 80, True), (1000, 80, True),     # mamba2-2.7b's heads and decay
    (300, 5, False),            # its head shapes, ragged, cum to ~-200
])
def test_ssd_chunk_kernel_at_full_chunk(cuda, S, H, mamba_decay, dtype):
    """mamba2-2.7b's chunk (P=64, N=128, Q=256), where |cum| grows to the
    hundreds or thousands: the kernel's error against a float64
    evaluation of the plain version is at most twice the float32 plain
    version's."""
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, S, H, 64, 128, dtype, 9,
                                    mamba_decay)
    got = SSD.ssd_chunk(xh, dt, A, Bm, Cm, 256)
    torch.cuda.synchronize()
    plain = ref.ssd_chunk_ref(xh, dt, A, Bm, Cm, 256)
    exact = ref.ssd_chunk_ref(*(t.double() for t in (xh, dt, A, Bm, Cm)),
                              256)
    for a, p, e in zip(got, plain, exact):
        assert torch.isfinite(a).all()
        err, perr = (float((t.double() - e).abs().max()) for t in (a, p))
        assert err <= 2 * perr + 1e-12, (err, perr)


def test_ssd_on_card_matches_plain_scan(cuda):
    """backend.ssd on CUDA tensors: the kernel forward (counted) within
    2e-5 of the plain scan, and grads equal to the plain scan's (the
    backward recomputes through it)."""
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, 2, 100, 3, 16, 8, torch.float32,
                                    10, False)
    D = torch.full((3,), 0.5, device=cuda)
    leaves = [t.detach().clone().requires_grad_()
              for t in (xh, dt, A, Bm, Cm, D)]
    before = SSD.launches
    y, h = KB.ssd(*leaves, chunk=32)
    assert SSD.launches == before + 1
    from repro_torch.models.mamba2 import ssd_chunked
    leaves2 = [t.detach().clone().requires_grad_()
               for t in (xh, dt, A, Bm, Cm, D)]
    wy, wh = ssd_chunked(*leaves2, chunk=32)
    _close(y, wy, torch.float32)
    _close(h, wh, torch.float32)
    gy = torch.randn_like(y)
    got = torch.autograd.grad((y * gy).sum() + h.sum(), leaves)
    want = torch.autograd.grad((wy * gy).sum() + wh.sum(), leaves2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_mamba2_train_step_on_card_matches_cpu(cuda):
    """One reduced mamba2 loss and its grads on the card (kernels) against
    the CPU (plain versions), float32, same weights: loss within 1e-4,
    grads within 1e-3 of each tensor's largest |grad|; the chunk kernel
    runs twice per layer under remat."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b").reduced()
    cpu = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                       trainable=True)
    card = R.init_model(cfg, seed=0, dtype=torch.float32, device="cpu",
                        trainable=True).to(cuda)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 81))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = SSD.launches
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {n: t.to(dev) for n, t in batch.items()}
        loss, _ = R.loss_fn(model, cfg, b, z_loss=1e-4, dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert SSD.launches == before + 2 * cfg.n_layers
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-4
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())
