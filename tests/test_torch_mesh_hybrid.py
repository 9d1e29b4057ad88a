"""The RG-LRU hybrid on data × model meshes of gloo processes, against
the reference's single-device step, on the CPU.

The reduced recurrentgemma-9b cut to 3 layers (recurrent, recurrent,
windowed MQA attention: ``reduced()`` keeps 2, both recurrent), LRU
width 256, window 64, at B 4 × S 80 (past the window), float32, remat
on, on 1x2 and 2x2.  The recurrent blocks are width-parallel (128
channels a rank; y gathered over the model group before the (W, W)
gates); the attention layer takes its one KV head, which the model axis
does not divide, gathered whole after the column-split products.  Loss
1e-5, every gathered grad within 1e-4 of its leaf's max, ``grad_norm``
within 1e-5 relative (``mesh_cases``).
"""
import pytest
import torch

import mesh_cases as MC

MESHES = ("1x2", "2x2")
CASES = {"hybrid": {"arch": "recurrentgemma-9b", "replace": {"n_layers": 3},
                    "B": 4, "S": 80, "seed": 2}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, got = MC.run_cases(tmp_path_factory.mktemp("mesh_hybrid"), CASES,
                             MESHES)
    return dict(refs=refs, got=got)


def test_the_case_has_mqa_attention_past_its_window():
    _, cfg = MC.configs(CASES["hybrid"])
    from repro_torch.models.rglru import kinds
    assert kinds(cfg) == ("recurrent", "recurrent", "attention")
    assert cfg.n_kv_heads == 1 and CASES["hybrid"]["S"] > \
        cfg.hybrid.local_window


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_loss_and_grads_match_single_device(runs, spec):
    MC.check_case(runs["refs"]["hybrid"], runs["got"][spec]["hybrid"])


@pytest.mark.parametrize("spec", MESHES)
def test_model_gathers_of_a_step(runs, spec):
    """y of each recurrent block and k, v of the attention layer, each
    gathered in the forward and in remat's recompute: (2 + 2) x 2."""
    c = runs["got"][spec]["hybrid"]["comms"]
    assert c["model_all_gather"]["calls"] == 8
