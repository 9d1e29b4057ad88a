"""The FLOPs model and the roofline, against the reference's, on the CPU.

- ``repro_torch.bench.flops`` equals ``benchmarks/flops_model.py``
  exactly (the same floats) for every arch × input shape × chips × remat
  × block_skip: ``step_flops``, ``forward_flops`` of each mode,
  ``hbm_bytes`` and ``model_flops_per_token``.
- ``repro_torch.bench.roofline.analyze_record`` with the v5e constants
  equals ``benchmarks/roofline.py``'s on the same records (every arch ×
  shape × mesh, collective bytes in and out of the loop); a record of
  the port's (every layer counted, nothing in a loop) is not multiplied
  by a trip count.  The constants are defined once (``launch.mesh``).
- ``FlopCounterMode`` on a shape-only step of the reduced seesaw-150m (one
  process, meta tensors): its count of the products is within 1% of the
  model's projection, MLP and head terms (``bench.flops``) run as often
  as the port runs them.  Without the layers' remat: the projections 3×
  forward; the MLP's up and gate 4× and its down 3× (the MLP's own
  remat, whose recompute stops before the down projection); the head 4×
  (the chunked loss recomputes its logits).  With it, one forward more
  for the attention block's projections (4×) and nothing more for the
  MLP, whose own remat already recomputes it; the reference's closed
  form charges every term 4×.  The kernels' counts go
  to ``kernels._build.meta_ops``: the flash forward, dq and dk/dv and
  the RMSNorm forward and backward at their bounds' counts.
"""

import numpy as np
import pytest
import torch

import benchmarks.flops_model as JF
import benchmarks.roofline as JRL
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro_torch.bench import flops as PF
from repro_torch.bench import roofline as PRL
from repro_torch.bench import timing
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import _build
from repro_torch.launch import mesh as MESH

ARCHS = j_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_model_equals_reference(arch):
    j, p = j_get_config(arch), get_config(arch)
    for name in J_SHAPES:
        js, ps = J_SHAPES[name], INPUT_SHAPES[name]
        for remat in (True, False):
            for bs in (True, False):
                assert PF.step_flops(p, ps, remat=remat, block_skip=bs) == \
                    JF.step_flops(j, js, remat=remat, block_skip=bs)
            for chips in (1, 4, 256, 512):
                assert PF.hbm_bytes(p, ps, chips=chips, remat=remat) == \
                    JF.hbm_bytes(j, js, chips=chips, remat=remat)
        for mode in ("train", "prefill", "decode"):
            for bs in (True, False):
                assert PF.forward_flops(p, 8, ps.seq_len, mode=mode,
                                        block_skip=bs) == \
                    JF.forward_flops(j, 8, js.seq_len, mode=mode,
                                     block_skip=bs)
    assert PF.model_flops_per_token(p) == JF.model_flops_per_token(j)
    assert PF.hbm_bytes(p, INPUT_SHAPES["train_4k"], chips=4,
                        n_params=p.param_count()) == \
        JF.hbm_bytes(j, J_SHAPES["train_4k"], chips=4)


# the reference's collective kinds (repro.launch.dryrun's _COLLECTIVES;
# that module sets a 512-device XLA flag when imported)
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _records(rng):
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            for mesh in ("16x16", "2x16x16"):
                yield {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "ok", "tag": "baseline",
                       "collective_bytes": {k: int(rng.integers(1 << 30))
                                            for k in _COLLECTIVES},
                       "collective_bytes_in_loop": {
                           k: int(rng.integers(1 << 28))
                           for k in _COLLECTIVES},
                       "memory_analysis": {
                           "temp_size_in_bytes": int(rng.integers(1 << 34)),
                           "argument_size_in_bytes": int(
                               rng.integers(1 << 34))},
                       "cost_analysis": {"flops": float(rng.random())},
                       "compile_s": 1.5}


def test_roofline_equals_reference_with_v5e_constants():
    rng = np.random.default_rng(0)
    n = 0
    for rec in _records(rng):
        want = JRL.analyze_record(rec)
        got = PRL.analyze_record(rec, PRL.V5E)
        assert {k: got[k] for k in want} == want, rec
        n += 1
    assert n == len(ARCHS) * len(INPUT_SHAPES) * 2
    skipped = {"arch": "yi-34b", "shape": "long_500k", "mesh": "16x16",
               "status": "skipped"}
    assert PRL.analyze_record(skipped) is None \
        and JRL.analyze_record(skipped) is None


def test_port_records_are_not_multiplied_by_a_trip_count():
    rec = next(_records(np.random.default_rng(1)))
    rec["collective_bytes_in_loop"] = {k: 0 for k in
                                       rec["collective_bytes_in_loop"]}
    rec["port_collectives"] = {}
    rec["model_params"] = 10 ** 9
    row = PRL.analyze_record(rec, PRL.H100)
    assert row["collective_bytes_dev"] == sum(
        rec["collective_bytes"].values())
    assert row["t_collective_s"] == row["collective_bytes_dev"] / 50e9
    cfg, shape = get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]]
    assert row["t_memory_held_s"] == PF.hbm_bytes(
        cfg, shape, chips=256, n_params=10 ** 9) / 3.35e12
    m = rec["memory_analysis"]
    assert row["peak_bytes_dev"] == m["argument_size_in_bytes"] + \
        m["temp_size_in_bytes"]
    assert row["peak_frac_hbm"] == row["peak_bytes_dev"] / 80e9


def test_constants_are_defined_once():
    import repro.launch.mesh as JM
    assert (MESH.PEAK_FLOPS_BF16, MESH.HBM_BW, MESH.ICI_BW) == (
        JM.PEAK_FLOPS_BF16, JM.HBM_BW, JM.ICI_BW)
    assert timing.HBM_BYTES_PER_S is MESH.H100_HBM_BW
    assert timing.PEAK_OPS[torch.bfloat16] is MESH.H100_PEAK_FLOPS_BF16
    assert timing.PEAK_OPS[torch.float32] is MESH.H100_PEAK_FLOPS_F32
    assert PRL.H100.peak_flops == 989e12 and PRL.H100.link_bw == 50e9


def _counted(remat: bool):
    """(products' FLOPs, kernels' operations) of one shape-only training
    step of the reduced seesaw-150m, B 2 × S 64, one process."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import OptimizerConfig
    from repro_torch.models import registry as R
    from repro_torch.optim import optimizers as O
    from repro_torch.train import engine as E
    cfg = get_config("seesaw-150m").reduced()
    model = R.family(cfg).Model(cfg, dtype=torch.float32,
                                device="meta").requires_grad_(True)
    opt = O.from_config(OptimizerConfig())
    state = opt.init(dict(model.named_parameters()))
    batch = {k: torch.zeros(2, 64, dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    step = E.make_grad_step(cfg, opt, remat=remat)
    _build.meta_ops = 0.0
    with FlopCounterMode(display=False) as fc:
        step(model, state, batch, torch.zeros((), device="meta"))
    return cfg, float(fc.get_total_flops()), _build.meta_ops


@pytest.mark.parametrize("remat", [False, True])
def test_counted_products_match_the_model_terms(remat):
    cfg, got, kernel_ops = _counted(remat)
    S, L = 2 * 64, cfg.n_layers
    attn = PF._attn_layer_flops(cfg, S, 64)
    proj = attn - 2 * S * 64 * cfg.q_dim * 2        # the scores' term out
    mlp, head = PF._mlp_flops(cfg, S), PF._vocab_flops(cfg, S)
    up_gate, down = mlp * 2 / 3, mlp / 3
    r = int(remat)
    want = L * ((3 + r) * proj + 4 * up_gate + 3 * down) + 4 * head
    assert abs(got - want) <= 0.01 * want, (got, want)
    pairs = 2 * cfg.n_heads * 64 * 65 / 2           # causal (q, k) pairs
    hd = cfg.head_dim
    fwd = (2 if remat else 1) * L * 4 * hd * pairs
    assert kernel_ops == pytest.approx(fwd + L * 14 * hd * pairs
                                       + (4 * L + 1 if remat else 2 * L + 1)
                                       * 4 * S * cfg.d_model
                                       + (2 * L + 1) * 12 * S * cfg.d_model)
