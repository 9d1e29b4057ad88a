"""Query heads the model axis does not divide, on the CPU: the reduced
llama3.2-3b with 6 query heads over 2 KV heads on a 1x4 mesh of gloo
processes, against the reference's single-device run on the same numpy
weights.

- The stored blocks are the reference's: a rank holds 6·64/4 = 96
  columns of ``w_q`` (1.5 heads) and 96 rows of ``w_o``.  The attention
  regroups them (``parallel.head_block``): ranks 0-2 attend 2 whole heads
  each and rank 3 none; rank 0's heads lie in KV head 0's group, rank
  1's straddle the two groups (a GQA group across two ranks), rank 2's
  lie in KV head 1's.
- Training (``mesh_cases.run_cases``, the residual whole, float32, remat
  on): loss 1e-5, every gathered grad within 1e-4 of its leaf's max,
  ``grad_norm`` 1e-5 relative.
- Serving (``mesh_cases.serve_runs``): the prefill and 4 greedy decode
  steps under both cache cuts, ``serve_resident`` off and on: logits
  within 2e-5 of the reference's, tokens equal, caches their boxes'
  shapes and within 2e-5.
- The regrouping's collectives, counted against the shapes: one
  training step adds, a layer, the q gather and the output gather (each
  with its backward's all-reduce, forward and recompute both gathering)
  to the KV gathers the 2 KV heads over 4 ranks already took.
"""
import pytest
import torch

import mesh_cases as MC
from repro_torch import parallel

UNEVEN = {"n_heads": 6, "n_kv_heads": 2}
TRAIN = {"uneven": {"arch": "llama3.2-3b", "replace": UNEVEN, "B": 2,
                    "S": 32, "seed": 0}}
SERVE = {"uneven": {"arch": "llama3.2-3b", "replace": UNEVEN, "S": 20,
                    "cap": 48, "seed": 1}}
MESH = "1x4"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The training and the serving ranks side by side (each job waits on
    its subprocesses in a thread of its own)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        train = ex.submit(MC.run_cases, tmp_path_factory.mktemp(
            "uneven_train"), TRAIN, (MESH,))
        serve = ex.submit(MC.serve_runs, tmp_path_factory.mktemp(
            "uneven_serve"), SERVE, (MESH,))
        return train.result(), serve.result()


@pytest.fixture(scope="module")
def train(runs):
    return runs[0]


@pytest.fixture(scope="module")
def serve(runs):
    return runs[1]


def test_head_blocks():
    assert [parallel.head_block(6, 4, r) for r in range(4)] == [
        (0, 2), (2, 2), (4, 2), (6, 0)]
    assert [parallel.head_block(24, 16, r) for r in (0, 11, 12, 15)] == [
        (0, 2), (22, 2), (24, 0), (24, 0)]
    assert parallel.head_block(56, 16, 13) == (52, 4)
    assert parallel.head_block(8, 4, 3) == (6, 2)


def test_training_matches_single_device(train):
    refs, got = train
    MC.check_case(refs["uneven"], got[MESH]["uneven"])


def test_training_collectives(train):
    """A layer's regrouping: the q gather (B·S·96 floats a rank) and the
    output gather (B·S·2·64, the block padded to 2 heads), each in the
    forward and the recompute, their backward all-reduces of the whole
    (B, S, 384) and (B, S, 512) grads; K and V gathered whole as for 2
    KV heads over 4 ranks."""
    _, got = train
    c = got[MESH]["uneven"]["comms"]
    B, S, L, f4 = 2, 32, 2, 4
    rows = B * S
    gathers = L * 2 * (rows * 96 + rows * 128 + 2 * rows * 32)
    assert round(c["model_all_gather"]["MB"] * 1e6) == gathers * f4
    assert c["model_all_gather"]["calls"] == L * 2 * 4
    assert c["slot_gather"]["calls"] == 0


def test_serving_matches_single_device(serve):
    MC.check_serving(serve, SERVE, "uneven", MESH)
