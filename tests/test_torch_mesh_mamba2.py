"""Mamba-2 on data × model meshes of gloo processes, against the
reference's single-device step, on the CPU.

The reduced mamba2 (d_inner 512: 8 SSD heads of 64, d_state 16, tied
head) at B 4 × S 96 (three chunks of 32), float32, remat on, on 1x2 and
2x2: head-parallel, 4 SSD heads a rank.  The conv's weights are cut over
the concatenated (x, B, C) channels, 544 of them, at channel 272, where
the heads' cut falls at 256: the rank gathers them and takes its heads'
channels and all of B and C.  The gated norm normalises over the whole
d_inner from the ranks' halves (the split-row RMSNorm's plain version
here).  Loss 1e-5, every gathered grad within 1e-4 of its leaf's max,
``grad_norm`` within 1e-5 relative (``mesh_cases``).
"""
import pytest
import torch

import mesh_cases as MC
from repro_torch.configs import get_config
from repro_torch.models.mamba2 import _dims

MESHES = ("1x2", "2x2")
CASES = {"mamba2": {"arch": "mamba2-2.7b", "B": 4, "S": 96, "seed": 1}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, got = MC.run_cases(tmp_path_factory.mktemp("mesh_mamba2"), CASES,
                             MESHES)
    return dict(refs=refs, got=got)


def test_the_conv_cut_is_not_the_heads_cut():
    _, di, H, _, N = _dims(get_config("mamba2-2.7b").reduced())
    assert ((di + 2 * N) // 2, di // 2) == (272, 256)
    _, di, H, _, N = _dims(get_config("mamba2-2.7b"))
    assert ((di + 2 * N) // 2, di // 2, H // 2) == (2688, 2560, 40)


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_loss_and_grads_match_single_device(runs, spec):
    MC.check_case(runs["refs"]["mamba2"], runs["got"][spec]["mamba2"])


@pytest.mark.parametrize("spec", MESHES)
def test_head_parallel_collectives(runs, spec):
    """Each layer gathers conv_w and conv_b over the model group, in the
    forward and again in remat's recompute: 2 x 2 x 2 gathers."""
    c = runs["got"][spec]["mamba2"]["comms"]
    assert c["model_all_gather"]["calls"] == 8
    assert (c["fsdp_gather"]["calls"] > 0) == (spec == "2x2")
