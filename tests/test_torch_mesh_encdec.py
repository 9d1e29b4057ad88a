"""The enc-dec and the VLM prefix on data × model meshes of gloo
processes, against the reference's single-device step, on the CPU.

- The tiny ``"encdec"`` config (2 encoder and 2 decoder layers, d 64, 4
  heads over 2 KV heads of 16, 24 frames): the encoder's bidirectional
  self-attention and MLP, the decoder's causal self-attention, its MLP
  and its cross-attention (the encoder output through ``to_model``
  before the column-parallel K/V) on the rank's heads; ``src_emb`` rows
  split over data.  The reduced seamless keeps all 12 encoder layers (a
  reference fault, ROADMAP Queue 3), so the tiny config stands for it.
- The reduced internvl2-76b with its 16-patch prefix: ``prefix_emb``
  rows split over data and whole on every model rank, the loss on the
  text only.
- Both at B 4, float32, remat on, with a mask, on 1x2 and 2x2: loss
  1e-5, every gathered grad within 1e-4 of its leaf's max, ``grad_norm``
  within 1e-5 relative (``mesh_cases``).  A mask keeps another count of
  tokens in each data slot, so the loss divides by the slots' mean
  count, summed over the data group.
"""
import pytest
import torch

import mesh_cases as MC

MESHES = ("1x2", "2x2")
TINY = dict(name="torch-tiny-encdec", arch_type="encdec", n_layers=2,
            n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=256, max_seq_len=128,
            rope_theta=1e4, act="gelu", frontend_tokens=24,
            frontend_dim=64)
CASES = {"encdec": {"fields": TINY, "B": 4, "S": 20, "seed": 3},
         "vlm": {"arch": "internvl2-76b", "B": 4, "S": 24, "seed": 4}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, got = MC.run_cases(tmp_path_factory.mktemp("mesh_encdec"), CASES,
                             MESHES)
    return dict(refs=refs, got=got)


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_grads_match_single_device(runs, case, spec):
    MC.check_case(runs["refs"][case], runs["got"][spec][case])


def test_data_group_reductions_of_a_step(runs):
    """1x2 has one data slot: its only data-group reduction is the
    norm's.  2x2 also reduces the gathers' grads, the replicated grads
    and metrics, and the masks' token count."""
    for case in CASES:
        one = runs["got"]["1x2"][case]["comms"]["grad_reduce"]["calls"]
        assert one == 1
        assert runs["got"]["2x2"][case]["comms"]["grad_reduce"]["calls"] > 3
