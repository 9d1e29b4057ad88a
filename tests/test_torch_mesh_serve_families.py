"""Sharded prefill and decode of the RG-LRU hybrid and the enc-dec on
data × model meshes of gloo processes, against the reference's
single-device ``prefill`` / ``decode_step`` on the same numpy weights,
prompts and frames, on the CPU (``mesh_cases``' serving machinery).

- Configs: the reduced recurrentgemma-9b at 5 layers (recurrent,
  recurrent, attention, recurrent, recurrent: one stacked group of the
  reference's layout and its unstacked remainder; MQA 4/1, hd 64, LRU
  width 256), its prompt of 72 wrapping its 64-slot ring; the reduced
  seamless-m4t-medium (``"audio"``: 12 encoder layers, 16 frames, GQA
  4/2); the tiny ``"encdec"`` config of ``test_torch_mesh_encdec.py``
  (24 frames, which 16 does not divide: its cross K/V stay cut on
  head_dim under the sequence cut).  B 16, float32.
- Meshes 1x2, 2x2 (8 rows a data slot) and 1x4 (the KV heads do not
  divide: each rank's query heads attend to a KV head it gathers);
  ``serve_resident`` off and on; the head_dim cut and the sequence cut.
- Each rank runs ``launch.steps.build_workload``'s prefill and decode
  ``fn``s: its vocab block of the logits within 2e-5 of the
  reference's at the prefill and each of 4 greedy steps, the greedy
  tokens equal, each cache leaf exactly its box's shape and within 2e-5
  of the reference's cut to it (``ek``/``ev`` after the permute to the
  port's order), each leaf's cut on the logical dim the reference's
  spec names, and a decode step's collectives byte for byte: the new
  token's q (and the self-attention's k, v), the scores or the softmax
  states, the re-cut of the attention outputs, y of each recurrent
  block and the rows' partial sums; no cache byte.
- hybrid and seamless decode with ``serve_resident`` on 2x2 are also
  held to the reference's own sharded jitted step on a forced 4-device
  host mesh, within 2e-5.
"""
import pytest
import torch

import mesh_cases as MC
from test_torch_mesh_encdec import TINY

B = MC.SERVE_B
MESHES = ("1x2", "2x2", "1x4")
CASES = {
    "hybrid": {"arch": "recurrentgemma-9b", "replace": {"n_layers": 5},
               "S": 72, "cap": 96, "seed": 7, "jit": True},
    "seamless": {"arch": "seamless-m4t-medium", "S": 12, "cap": 32,
                 "seed": 8, "jit": True},
    "tiny": {"fields": TINY, "S": 10, "cap": 32, "seed": 9},
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
    return MC.serve_runs(tmp_path_factory.mktemp("mesh_serve_families"),
                         CASES, MESHES)


def _config(name):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    return MC.serve_config(get_config, CASES[name], ModelConfig)


def test_the_cases_cover_both_layouts_and_the_ring():
    from repro_torch.models.rglru import groups
    cfg = _config("hybrid")
    pat, n_full, rem = groups(cfg)
    assert (n_full, rem) == (1, ["recurrent", "recurrent"])
    assert cfg.n_kv_heads == 1 and CASES["hybrid"]["S"] > \
        cfg.hybrid.local_window
    assert _config("seamless").arch_type == "audio"
    assert _config("seamless").n_encoder_layers == 12
    assert _config("tiny").arch_type == "encdec"


@pytest.mark.parametrize("name,spec", [(n, s) for n in CASES
                                       for s in MESHES])
def test_sharded_serving_matches_single_device(runs, name, spec):
    MC.check_serving(runs, CASES, name, spec)


def _cut_names(name, seq_cut):
    """Each leaf's logical dim the reference's spec cuts over 'model':
    the recurrent states over their channels; a ring or a self-attention
    cache over its slots with the sequence cut (which needs a multiple of
    16), else head_dim; the cross K/V over the frames with the sequence
    cut where 16 divides them, else head_dim."""
    if name == "hybrid":
        return {"conv": "channels", "h": "channels", "pos": None,
                "k": "seq" if seq_cut else "head_dim",
                "v": "seq" if seq_cut else "head_dim"}
    frames = seq_cut and _config(name).frontend_tokens % 16 == 0
    kv = "seq" if seq_cut else "head_dim"
    cross = "frames" if frames else "head_dim"
    return {"k": kv, "v": kv, "ek": cross, "ev": cross}


# each leaf's logical dims, in the port's order of its dims
_PORT_DIMS = {"conv": ("rows", "taps", "channels"), "h": ("rows", "channels"),
              "pos": ("slots",),
              "k": ("layer", "rows", "seq", "kv_heads", "head_dim"),
              "ek": ("layer", "rows", "kv_heads", "frames", "head_dim")}
_PORT_DIMS["v"], _PORT_DIMS["ev"] = _PORT_DIMS["k"], _PORT_DIMS["ek"]


@pytest.mark.parametrize("spec", MESHES)
def test_caches_are_cut_as_the_reference_specs_say(runs, spec):
    for name in CASES:
        for resident, seq_cut in MC.serve_combos(CASES[name]):
            rec = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                       f"{int(seq_cut)}"]
            for leaf, want in _cut_names(name, seq_cut).items():
                dims = _PORT_DIMS[leaf]
                if name == "hybrid" and leaf in ("k", "v"):
                    dims = dims[1:]                  # a layer's ring
                got = rec["cut"][leaf]
                assert (got and dims[got[0]]) == want, (name, leaf,
                                                        rec["cut"])


def _decode_bytes(name, spec, seq_cut):
    """A decode step's bytes by collective kind, from the shapes alone
    (float32): the embedding's sum and every row-parallel product's;
    each recurrent block's y; each attention's new q (and the self
    attention's k, v); under the head_dim cut the scores (H·Skv floats a
    row) and the output's re-cut, under the sequence cut the softmax
    states.  No term is a cache block."""
    from repro_torch.models.rglru import _hybrid, kinds
    cfg = _config(name)
    D, M = (int(x) for x in spec.split("x"))
    b, f4 = B // D, 4
    L, d = cfg.n_layers, cfg.d_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cuts = _cut_names(name, seq_cut)
    want = {"model_all_reduce": b * d * f4, "model_all_gather": 0,
            "model_all_to_all": 0}

    def attend(n, skv, cut, q_only=False):
        want["model_all_reduce"] += n * b * d * f4        # w_o
        want["model_all_gather"] += n * b * (
            H if q_only else H + 2 * Hkv) * hd // M * f4
        if cut == "head_dim":
            want["model_all_reduce"] += n * b * H * skv * f4
            want["model_all_to_all"] += n * b * H * hd // M * f4
        else:
            want["model_all_gather"] += n * b * H * (hd + 2) * f4

    if cfg.arch_type == "hybrid":
        h_cfg, W = _hybrid(cfg)
        n_attn = sum(k == "attention" for k in kinds(cfg))
        n_rec = L - n_attn
        want["model_all_reduce"] += L * b * d * f4          # the MLPs
        want["model_all_reduce"] += n_rec * b * d * f4      # w_out
        want["model_all_gather"] += n_rec * b * W // M * f4  # y
        attend(n_attn, min(h_cfg.local_window, CASES[name]["cap"]),
               cuts["k"])
    else:
        want["model_all_reduce"] += L * b * d * f4          # the MLPs
        attend(L, CASES[name]["cap"], cuts["k"])
        attend(L, cfg.frontend_tokens, cuts["ek"], q_only=True)
    return want


@pytest.mark.parametrize("spec", MESHES)
def test_a_decode_step_moves_no_cache_bytes(runs, spec):
    for name in CASES:
        for resident, seq_cut in MC.serve_combos(CASES[name]):
            c = runs["got"][spec][0][f"{name}/{int(resident)}/"
                                     f"{int(seq_cut)}"]["comms"]
            want = _decode_bytes(name, spec, seq_cut)
            got = {k: round(c[k]["MB"] * 1e6) for k in want}
            assert got == want, (name, resident, seq_cut, got, want)
            assert (c["fsdp_gather"]["calls"] > 0) == (
                not resident and spec == "2x2"), (name, resident)
            assert c["grad_reduce"]["calls"] == 0


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].get("jit")])
def test_reference_sharded_jitted_step_agrees(runs, name):
    MC.check_jit(runs, name)
