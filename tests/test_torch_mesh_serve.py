"""Sharded prefill and decode on data × model meshes of gloo processes,
against the reference's single-device ``prefill`` / ``decode_step`` on
the same numpy weights and prompts, on the CPU.

- Configs (``reduced()``): llama3.2-3b (GQA 4/2), starcoder2-3b (its
  window of 64: a 64-slot ring, the prompt of 72 wrapping it),
  granite-moe-1b-a400m (4 experts, top 2), internvl2-76b (a 16-row
  prefix) and mamba2-2.7b (8 SSD heads, d_state 16), and mamba2 at d 512
  (16 heads: ``cache_seq_shard`` cuts its state by heads, as at
  mamba2-2.7b's 80) and at d_state 4 (neither its state nor its conv
  divides into 16: both whole on every model rank).  B 16, float32.
- Meshes: 1x2, 2x2 (the batch cut over data: 8 rows a slot) and 1x4 (the
  KV heads 2 < 4: each rank's one query head attends to a KV head shared
  with a neighbour); ``serve_resident`` off and on, the head_dim cut and
  the sequence cut of the cache.  On 2x2 the MoE's decode routes one
  group of the 16 tokens, which spans the two data slots of 8: each rank
  gathers the group's rows over the slots (``TensorParallel.
  slot_gather``), routes it whole and keeps its own rows.
- Each rank runs ``launch.steps.build_workload``'s prefill and decode
  ``fn``s (and ``registry.prefill`` for the cache): its vocab block of
  the logits within 2e-5 of the reference's at the prefill and each of 4
  greedy steps, the greedy tokens (``TensorParallel.greedy``) equal to
  the reference's, each cache leaf exactly the shape of its box and
  within 2e-5 of the reference's cache cut to it, after the prefill and
  after the steps.  A decode step's collectives are counted by kind and
  size: the new token's q, k and v, the scores or the softmax states, the
  attention output's re-cut and the rows' partial sums; no cache byte.
- Two cases, llama3.2-3b's and granite-moe-1b-a400m's decode with
  ``serve_resident`` on 2x2, are also held to the reference's own
  sharded jitted step (``build_workload`` jitted with its in/out
  shardings on a forced 4-device host mesh, in a subprocess), within
  2e-5.
"""
import pytest
import torch

import mesh_cases as MC

B = MC.SERVE_B
MESHES = ("1x2", "2x2", "1x4")
CASES = {
    "llama": {"arch": "llama3.2-3b", "S": 20, "cap": 48, "seed": 0,
              "jit": True},
    "starcoder2": {"arch": "starcoder2-3b", "S": 72, "cap": 96, "seed": 1},
    "granite": {"arch": "granite-moe-1b-a400m", "S": 16, "cap": 32,
                "seed": 2, "jit": True},
    "internvl": {"arch": "internvl2-76b", "S": 12, "cap": 48, "seed": 3},
    "mamba2": {"arch": "mamba2-2.7b", "S": 40, "seed": 4},
    "mamba2_h16": {"arch": "mamba2-2.7b", "replace": {"d_model": 512},
                   "S": 40, "seed": 5, "layouts": [True]},
    "mamba2_n4": {"arch": "mamba2-2.7b", "ssm": {"d_state": 4}, "S": 40,
                  "seed": 6, "layouts": [False]},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MC.serve_runs(tmp_path_factory.mktemp("mesh_serve"), CASES,
                         MESHES)


def _combos(name):
    return MC.serve_combos(CASES[name])


@pytest.mark.parametrize("name,spec", [
    (n, s) for n in CASES for s in MESHES
    if s not in CASES[n].get("refuse", [])])
def test_sharded_serving_matches_single_device(runs, name, spec):
    MC.check_serving(runs, CASES, name, spec)


def test_moe_decode_gathers_its_group_across_two_slots(runs):
    """granite on 2x2: a decode step's group of 16 tokens spans the two
    slots of 8, so each MoE layer gathers the slot's 8 rows (one
    all-gather a layer); on 1x2 and 1x4 a slot holds the group."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-1b-a400m").reduced()
    for spec in MESHES:
        for resident, seq_cut in _combos("granite"):
            c = runs["got"][spec][0][f"granite/{int(resident)}/"
                                     f"{int(seq_cut)}"]["comms"]
            want = cfg.n_layers if spec == "2x2" else 0
            assert c["slot_gather"]["calls"] == want, (spec, c)


def _cut_dim(name, seq_cut):
    """Each leaf's dim the reference's specs cut over 'model': Mamba-2's
    state by N, or by heads (16 of them) with the sequence cut; its conv
    by channels; K/V by head_dim, or by the sequence."""
    if name == "mamba2_h16":
        return {"h": 2, "conv": 3}
    if name == "mamba2":
        return {"h": 4, "conv": 3}
    if name == "mamba2_n4":
        return {"h": None, "conv": None}
    return {"k": 2 if seq_cut else 4, "v": 2 if seq_cut else 4}


@pytest.mark.parametrize("spec", MESHES)
def test_caches_are_cut_as_the_specs_say(runs, spec):
    for name in CASES:
        if spec in CASES[name].get("refuse", []):
            continue
        for resident, seq_cut in _combos(name):
            rec = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                       f"{int(seq_cut)}"]
            for leaf, dim in _cut_dim(name, seq_cut).items():
                got = rec["cut"][leaf]
                assert (got and got[0]) == dim, (name, leaf, rec["cut"])


def _decode_bytes(name, spec, resident, seq_cut):
    """A decode step's bytes by collective kind, from the shapes alone:
    no term scales with the cache but the head_dim cut's scores (H·Skv
    floats a row and layer)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.mamba2 import _dims
    c = CASES[name]
    cfg = MC.serve_config(get_config, c, ModelConfig)
    D, Mm = (int(x) for x in spec.split("x"))
    b = B // D if B % 16 == 0 else B          # the rank's rows
    L, d, f4 = cfg.n_layers, cfg.d_model, 4
    want = {"model_all_reduce": b * d * f4, "model_all_gather": 0,
            "model_all_to_all": 0, "slot_gather": 0}  # the embedding's sum
    if cfg.arch_type == "moe" and D > 1:     # the group's rows of 2 slots
        want["slot_gather"] = L * b * d * f4
    if cfg.arch_type == "ssm":
        s, di, H, P, N = _dims(cfg)
        C = di + 2 * N
        want["model_all_gather"] = L * b * di // Mm * f4
        if C % 16:                           # the conv whole: its weights
            want["model_all_gather"] += L * (s.d_conv + 1) * C // Mm * f4
        else:                                # its channels: the output
            want["model_all_gather"] += L * b * C // Mm * f4
        want["model_all_reduce"] += L * (b * d * f4 + b * f4)
        if not (seq_cut and H % 16 == 0) and N % 16 == 0:   # the N cut
            want["model_all_reduce"] += L * b * H * P * f4
        return want
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    skv = min(c["cap"], cfg.sliding_window or c["cap"])
    want["model_all_gather"] = L * b * (H + 2 * Hkv) * hd // Mm * f4
    want["model_all_reduce"] += L * 2 * b * d * f4
    if seq_cut:
        want["model_all_gather"] += L * b * H * (hd + 2) * f4
    else:
        want["model_all_reduce"] += L * b * H * skv * f4
        want["model_all_to_all"] = L * b * H * hd // Mm * f4
    return want


@pytest.mark.parametrize("spec", MESHES)
def test_a_decode_step_moves_no_cache_bytes(runs, spec):
    for name in CASES:
        if spec in CASES[name].get("refuse", []):
            continue
        for resident, seq_cut in _combos(name):
            c = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                     f"{int(seq_cut)}"]["comms"]
            want = _decode_bytes(name, spec, resident, seq_cut)
            got = {k: round(c[k]["MB"] * 1e6) for k in want}
            assert got == want, (name, resident, seq_cut, got, want)
            assert (c["fsdp_gather"]["calls"] > 0) == (
                not resident and spec == "2x2"), (name, resident)
            assert c["grad_reduce"]["calls"] == 0


def test_reference_sharded_jitted_step_agrees(runs):
    MC.check_jit(runs, "llama")


def test_reference_sharded_jitted_moe_step_agrees(runs):
    """The reference's jitted granite decode on 2x2 routes the group of
    16 whole, constrained over data; the port's ranks agree with it."""
    MC.check_jit(runs, "granite")
