"""The MoE family on data × model meshes of gloo processes, against the
reference's single-device step, on the CPU.

- Loss, metrics and grads: the reduced granite-moe-1b-a400m (4 experts,
  top-2, GQA 4/2, tied head) at B 8 × S 512, float32, remat on, on 1x2
  and 2x2: expert-parallel (2 experts a rank), each data slot routing
  one whole group of 2,048 tokens; and at B 4 on 2x2, where the one
  group spans the two slots (gathered over them, routed whole).  Loss
  1e-5, ``lb_loss``, ``rz_loss`` and ``frac_dropped`` 1e-5, every
  gathered grad within 1e-4 of its leaf's max, ``grad_norm`` within
  1e-5 relative (``mesh_cases``).
- The launcher: ``launch.train --arch granite-moe-1b-a400m --reduced
  --mesh 2x2 --device cpu --dtype float32 --seq-len 1024 --batch-size
  4`` as four ranks, from the reference ``Trainer``'s step-0 checkpoint,
  a Seesaw ramp across one cut (B 4 then 8: one, then two groups of
  2,048 a data slot), step for step against the JAX ``Trainer`` on one
  device: loss within 5e-4; step, tokens, LR, batch and phase equal;
  ``lb_loss`` and ``frac_dropped`` within 5e-3.
"""
import json

import numpy as np
import pytest
import torch

import mesh_cases as MC
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.train.trainer import Trainer as JTrainer

ARCH = "granite-moe-1b-a400m"
MESHES = ("1x2", "2x2")
CASES = {"granite": {"arch": ARCH, "B": 8, "S": 512, "seed": 0},
         # 2 rows of 512 a slot on 2x2: the group of 2,048 spans 2 slots
         "granite_span": {"arch": ARCH, "B": 4, "S": 512, "seed": 1}}
SEQ, B0, STEPS = 1024, 4, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ranks and the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cfg(pkg):
    """What ``launch.train --reduced --batch-size 4 --seq-len 1024
    --steps 7 --max-cuts 1 --dtype float32`` builds for granite: a
    Seesaw ramp B 4 -> 8 (6 steps)."""
    return pkg.RunConfig(
        model=pkg.get_config(ARCH).reduced(),
        schedule=pkg.ScheduleConfig(kind="seesaw", base_lr=3e-3, alpha=2.0,
                                    beta=2.0, n_cuts=1, ema_decay=0.98,
                                    plateau_window=50,
                                    plateau_threshold=2e-3),
        optimizer=pkg.OptimizerConfig(kind="adamw"), seq_len=SEQ,
        global_batch_size=B0, total_tokens=STEPS * B0 * SEQ,
        dtype="float32")


LAUNCH = r'''
import json, os, sys
import torch
torch.set_num_threads(1)
rank, world, port, d, spec = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch.launch import train as launch_train
hist = launch_train.main([
    "--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
    "--dtype", "float32", "--seq-len", "1024", "--batch-size", "4",
    "--steps", "7", "--max-cuts", "1", "--checkpoint",
    os.path.join(d, "jck0"), "--resume", "--mesh", spec,
    "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
    "--process-id", str(rank)])
with open(os.path.join(d, f"launch{rank}.json"), "w") as f:
    json.dump(hist, f)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The grad ranks on both meshes beside the references; the JAX
    ``Trainer``'s step-0 checkpoint, the launcher's 2x2 ranks resuming
    it, and the JAX run."""
    import repro.configs as JC
    d = tmp_path_factory.mktemp("mesh_moe")
    jtr = JTrainer(run_cfg(JC))
    jtr.save_checkpoint(str(d / "jck0"))
    launch = MC.spawn(d, "2x2", LAUNCH)
    refs, got = MC.run_cases(d, CASES, MESHES)
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, SEQ))
    MC.wait(launch, timeout=600)
    hists = []
    for r in range(4):
        with open(d / f"launch{r}.json") as f:
            hists.append(json.load(f))
    return dict(refs=refs, got=got, jtr=jtr, hists=hists)


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_loss_and_grads_match_single_device(runs, spec):
    MC.check_case(runs["refs"]["granite"], runs["got"][spec]["granite"],
                  metrics=("loss", "ce_loss", "lb_loss", "rz_loss",
                           "frac_dropped"))


def test_group_across_two_slots_matches_single_device(runs):
    """B 4 × S 512 on 2x2: each data slot holds 1,024 tokens of the one
    routing group of 2,048, so each MoE layer gathers the group's rows
    over the two slots (forward and recompute; its backward sums the
    grads over them) and routes it whole, as the reference does."""
    got = runs["got"]["2x2"]["granite_span"]
    MC.check_case(runs["refs"]["granite_span"], got,
                  metrics=("loss", "ce_loss", "lb_loss", "rz_loss",
                           "frac_dropped"))
    L, rows, d = 2, 2 * 512, 256
    c = got["comms"]
    assert c["slot_gather"]["calls"] == 2 * L
    assert round(c["slot_gather"]["MB"] * 1e6) == 2 * L * rows * d * 4
    assert runs["got"]["1x2"]["granite_span"]["comms"]["slot_gather"][
        "calls"] == 0


@pytest.mark.parametrize("spec", MESHES)
def test_expert_parallel_collectives(runs, spec):
    """No model gather (the experts are the rank's own); with a data
    axis each layer's weights are gathered twice under remat."""
    c = runs["got"][spec]["granite"]["comms"]
    assert c["model_all_gather"]["calls"] == 0
    assert c["model_all_reduce"]["calls"] > 0
    assert (c["fsdp_gather"]["calls"] > 0) == (spec == "2x2")


def test_launcher_on_a_2x2_mesh_matches_the_jax_trainer(runs):
    want, hists = runs["jtr"].history, runs["hists"]
    assert [h["batch_size"] for h in want] == [4] * 4 + [8] * 2
    for hist in hists:
        assert len(hist) == len(want)
        for a, b in zip(hist, want):
            assert [a[k] for k in ("step", "tokens", "batch_size",
                                   "phase")] == \
                [b[k] for k in ("step", "tokens", "batch_size", "phase")]
            assert np.float32(a["lr"]) == np.float32(b["lr"])
            assert abs(a["loss"] - b["loss"]) < 5e-4, (a, b)
            for k in ("lb_loss", "frac_dropped"):
                assert abs(a[k] - b[k]) < 5e-3, (k, a, b)
        assert [h["loss"] for h in hist] == [h["loss"] for h in hists[0]]
