"""The port's multi-process data parallelism against the reference and
against its own single process, on the CPU.

- The per-host loader: the port's shards equal the reference's simulated
  per-host loaders token for token (steps, chunks, ``resume``,
  ``rechunk``), and their concatenation is the single-process stream.
- The checks: ``validate_per_host_plan``, ``micro_batches`` and the row
  blocks raise on the same plans with the same messages as the
  reference's; the launcher's argument checks and its init retry.
- Two ranks (gloo, spawned on free ports, each ``python -c`` over the
  port) against one: a Seesaw run over two phases of the reduced
  seesaw-150m in float32 (loss within 1e-5 step for step, LR, batch
  and phase equal, final weights within 1e-5 of each tensor's max; the
  one-rank run held to the JAX ``Trainer`` at 5e-4, as
  ``tests/test_torch_train.py``); an adaptive run whose ranks cut at
  the one-rank run's steps; resumes 2 → 2 (bitwise), 2 → 1 and 1 → 2
  (within the tolerance above).
- The checkpoint: a two-rank save's ``.npy`` files byte-equal a
  one-rank save's, the manifest's writers are the reference's rotation
  for two processes, ``save_process_count`` is 2, and the reference
  restores it.  A rank killed after its blocks and before its marker
  leaves the previous generation committed and restorable; the next
  save clears the stale marker.
- The stop: SIGTERM to one launcher process stops both at one boundary.

The 1e-5 covers float32 summation order: one rank sums a step's
micro-batch grads in one order, two ranks in another.  At
``max_device_batch`` 2 the first phase (B = 4) splits alike on one rank
(two micro-batches of 2 rows) and on two (2 rows a rank), so the runs
are bitwise equal there; the second (B = 8: four micro-batches on one
rank, two a rank on two) sums in another order.  AdamW turns that order
into weight differences mostly where a grad element is near its eps: at
3 steps of B = 8 the token embedding is 8.3e-7 of its max apart, at 4
steps it was 1.34e-5 (every other tensor within 2e-7).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import seesaw as JSS
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.data import validate_per_host_plan as j_validate
from repro.launch import mesh as JM
from repro.launch import train as j_launch
from repro.optim import optimizers as JO
from repro.train import checkpoint as JCKPT
from repro.train import engine as JE
from repro.train.trainer import Trainer as JTrainer
from repro_torch.core import seesaw as SS
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.data import validate_per_host_plan
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.optim import optimizers as O
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the runs' configs, shared by this file and the rank processes it
# starts (``exec``'d in both)
CONFIGS = r'''
SEQ, B0, STEPS, MID, FUSE, MAX_DEV, ADAPT_STEPS = 16, 4, 20, 10, 2, 2, 32


def run_cfg(pkg, kind="seesaw"):
    """The reduced seesaw-150m in float32, remat off, over a two-phase
    Seesaw ramp (B 4 -> 8: 14 + 3 steps) or the adaptive ramp (cuts
    within ADAPT_STEPS); ``pkg`` is repro_torch.configs or
    repro.configs."""
    sch = dict(kind=kind, base_lr=1e-3, alpha=2.0, n_cuts=1)
    total = SEQ * B0 * STEPS
    if kind == "adaptive-seesaw":
        # from the JAX init, cuts at steps 8 and 24 for every threshold
        # in (-0.0043, 0.0111) (chip_smoke.controller_replay over the
        # one-rank run's losses): the gains sit >5e-3 from 0.005, the
        # runs' losses ~1e-6 apart
        sch.update(n_cuts=2, warmup_frac=0.02, plateau_window=4,
                   plateau_threshold=5e-3, ema_decay=0.5,
                   plateau_min_steps=4)
        total = SEQ * B0 * 120
    return pkg.RunConfig(
        model=pkg.get_config("seesaw-150m").reduced(),
        schedule=pkg.ScheduleConfig(**sch),
        optimizer=pkg.OptimizerConfig(kind="adamw"), seq_len=SEQ,
        global_batch_size=B0, total_tokens=total, dtype="float32",
        remat=False)


def port_trainer(kind, init):
    import repro_torch.configs as C
    from repro_torch.train.trainer import Trainer
    tr = Trainer(run_cfg(C, kind), device="cpu", fuse_steps=FUSE,
                 max_device_batch=MAX_DEV)
    tr.state.model.load_state_dict(init)
    return tr


def port_loader(tr, tokens=0, per_host=True):
    from repro_torch.data import MarkovLM, PhaseDataLoader
    return PhaseDataLoader(MarkovLM(512, seed=0), tr.plan, SEQ,
                           device="cpu", per_host=per_host,
                           validate=not tokens).resume(tokens)
'''
exec(CONFIGS)

# one rank of the two-rank runs: uninterrupted Seesaw with a save at
# MID, the final state saved, 2 -> 2 and 1 -> 2 resumes, the adaptive run
TRAIN = CONFIGS + r'''
import os, sys
import torch
torch.set_num_threads(1)
rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
from repro_torch.launch.train import maybe_init_distributed
assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
init = torch.load(os.path.join(d, "init.pt"))
out = {}


def record(tr):
    return {"history": tr.history, "cut_steps": (
                tr.controller.cut_steps if tr.controller else None),
            "params": {n: p.detach().clone()
                       for n, p in tr.state.model.named_parameters()}}


tr = port_trainer("seesaw", init)


def save_mid():
    if tr.state.step == MID:
        tr.save_checkpoint(os.path.join(d, "ck2"))
    return False


tr.run(port_loader(tr), stop_fn=save_mid)
tr.save_checkpoint(os.path.join(d, "ck2_final"))
out["uninterrupted"] = record(tr)
for name, ck in (("resumed_2_2", "ck2"), ("resumed_1_2", "ck1")):
    tr = port_trainer("seesaw", init)
    tr.restore_checkpoint(os.path.join(d, ck), verify=True)
    tr.run(port_loader(tr, tr.state.tokens_seen))
    out[name] = record(tr)
tr = port_trainer("adaptive-seesaw", init)
tr.run(port_loader(tr), max_steps=ADAPT_STEPS)
out["adaptive"] = record(tr)
torch.save(out, os.path.join(d, f"out{rank}.pt"))
'''

# a rank killed mid-save: both ranks commit generation 0 synchronously,
# then rank 1 dies in its writer thread after its blocks, before its
# marker; rank 0 must time out on the missing marker, not commit
KILL = CONFIGS + r'''
import json, os, signal, sys
import torch
torch.set_num_threads(1)
rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
from repro_torch.launch.train import maybe_init_distributed
assert maybe_init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
from repro_torch.train import checkpoint as CKPT
init = torch.load(os.path.join(d, "init.pt"))
tr = port_trainer("seesaw", init)
tr.run(port_loader(tr), max_steps=4)
ck = os.path.join(d, "ck")
tr.save_checkpoint(ck)
if rank == 0:
    torch.save({n: p.detach().clone()
                for n, p in tr.state.model.named_parameters()},
               os.path.join(d, "gen0.pt"))
tr.run(port_loader(tr, tr.state.tokens_seen), max_steps=6)
if rank == 1:
    def die(*a, **k):
        os.kill(os.getpid(), signal.SIGKILL)
    CKPT._write_marker = die
tr.checkpoint_manager.commit_timeout = 3.0
tr.save_checkpoint(ck, block=False)
try:
    tr.close()
    err = None
except CKPT.CheckpointTimeoutError as e:
    err = str(e)
print(json.dumps({"rank": rank, "timeout_error": err,
                  "committed_gen": CKPT._committed_generation(ck),
                  "markers": sorted(n for n in os.listdir(ck)
                                    if n.startswith(".save-"))}),
      flush=True)
os._exit(0)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _spawn(script, d, world=2):
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), port, str(d)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs, timeout=240):
    out = []
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        out.append((p.returncode, o, e))
    return out


# --------------------------------------------------------------------- #
# the per-host loader against the reference's simulated hosts
# --------------------------------------------------------------------- #

def _plans(kind="seesaw"):
    kw = dict(kind=kind, base_lr=1e-3, total_tokens=32 * 8 * 40,
              warmup_frac=0.1, b0=8, alpha=2.0,
              n_cuts=2 if kind == "seesaw" else 8)
    return SS.build_plan(**kw), JSS.build_plan(**kw)


def _shards(plan, jplan, n, **kw):
    ours = [PhaseDataLoader(MarkovLM(128, seed=0), plan, 32, device="cpu",
                            per_host=True, process_index=p,
                            process_count=n, **kw) for p in range(n)]
    theirs = [JLoader(JMarkovLM(128, seed=0), jplan, 32, per_host=True,
                      process_index=p, process_count=n, **kw)
              for p in range(n)]
    return ours, theirs


@pytest.mark.parametrize("n", [2, 4])
def test_per_host_steps_match_reference(n):
    plan, jplan = _plans()
    ours, theirs = _shards(plan, jplan, n)
    single = list(PhaseDataLoader(MarkovLM(128, seed=0), plan, 32,
                                  device="cpu"))
    for p in range(n):
        got, want = list(ours[p]), list(theirs[p])
        assert len(got) == len(want) == len(single)
        for (ph, s, b), (jph, js, jb) in zip(got, want):
            assert (ph.index, s) == (jph.index, js)
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          np.asarray(jb["tokens"]))
    shards = [list(lo) for lo in ours]
    for i, (_, _, b) in enumerate(single):
        np.testing.assert_array_equal(
            b["tokens"].numpy(),
            np.concatenate([sh[i][2]["tokens"].numpy() for sh in shards]))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("resume", [0, 5])
def test_per_host_chunks_and_resume_match_reference(n, resume):
    plan, jplan = _plans()
    single = list(PhaseDataLoader(MarkovLM(128, seed=0), plan, 32,
                                  device="cpu"))
    tok = sum(p.batch_size * 32 for p, _, _ in single[:resume])
    ours, theirs = _shards(plan, jplan, n, validate=not resume)
    chunks = []
    for lo, jlo in zip(ours, theirs):
        got = list(lo.resume(tok).iter_chunks(4))
        want = list(jlo.resume(tok).iter_chunks(4))
        assert len(got) == len(want)
        for (ph, c, m), (jph, jc, jm) in zip(got, want):
            assert (ph.index, m) == (jph.index, jm)
            np.testing.assert_array_equal(c["tokens"].numpy(),
                                          np.asarray(jc["tokens"]))
        chunks.append([c["tokens"].numpy() for _, c, _ in got])
    whole = PhaseDataLoader(MarkovLM(128, seed=0), plan, 32, device="cpu")
    for i, (_, c, _) in enumerate(whole.resume(tok).iter_chunks(4)):
        np.testing.assert_array_equal(
            c["tokens"].numpy(),
            np.concatenate([ch[i] for ch in chunks], axis=1))


@pytest.mark.parametrize("n", [2, 4])
def test_per_host_rechunk_matches_reference(n):
    plan, jplan = _plans("adaptive-seesaw")
    ours, theirs = _shards(plan, jplan, n)
    cut = 6 * 8 * 32
    plan, jplan = (p.extend_at(cut, seq_len=32) for p in (plan, jplan))
    for lo, jlo in zip(ours, theirs):
        got = list(lo.rechunk(plan, cut).iter_chunks(4))
        want = list(jlo.rechunk(jplan, cut).iter_chunks(4))
        assert len(got) == len(want) >= 2
        assert {c["tokens"].shape[1] for _, c, _ in got} == {16 // n}
        for (ph, c, m), (jph, jc, jm) in zip(got, want):
            assert (ph.index, m) == (jph.index, jm)
            np.testing.assert_array_equal(c["tokens"].numpy(),
                                          np.asarray(jc["tokens"]))


# --------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------- #

def _outcome(fn, *a, **k):
    try:
        fn(*a, **k)
        return None
    except (ValueError, AssertionError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("b0", [2, 4, 6, 12])
def test_validate_per_host_plan_matches_reference(nproc, b0):
    kw = dict(kind="seesaw", base_lr=1e-3, total_tokens=16 * b0 * 60,
              warmup_frac=0.1, b0=b0, alpha=2.0, n_cuts=3)
    plan, jplan = SS.build_plan(**kw), JSS.build_plan(**kw)
    for ndev in (1, nproc, 2 * nproc):
        for start in range(len(plan.phases)):
            assert _outcome(validate_per_host_plan, plan, nproc, ndev,
                            start_phase=start) == \
                _outcome(j_validate, jplan, nproc, ndev,
                         start_phase=start)


class _Mesh:
    def __init__(self, n):
        self.shape = {"data": n, "model": 1}


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_micro_batches_match_reference(ranks):
    import repro.configs as JC
    import repro_torch.configs as C
    plan, jplan = _plans()
    for mdb in (None, 1, 2, 3, 8):
        eng = E.PhaseEngine(run_cfg(C), O.adamw(), plan,
                            max_device_batch=mdb)
        eng.world = ranks
        jeng = JE.PhaseEngine(run_cfg(JC), JO.adamw(), jplan,
                              mesh=_Mesh(ranks), max_device_batch=mdb)
        assert eng.n_data_devices() == jeng.n_data_devices() == ranks
        for b in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32):
            got = _outcome(eng.micro_batches, b)
            assert got == _outcome(jeng.micro_batches, b), (mdb, b)
            if got is None:
                assert eng.micro_batches(b) == jeng.micro_batches(b)


@pytest.mark.parametrize("layout", [
    {0: {0, 1}, 1: {2, 3}}, {0: {0, 2}, 1: {1, 3}}, {1: {0, 1}, 0: {2, 3}},
    {0: {0}, 1: {1}, 2: {2}}, {0: {0, 1, 2}}])
@pytest.mark.parametrize("n_rows,nproc", [(4, 2), (3, 3), (4, 3), (3, 1)])
def test_row_block_check_matches_reference(layout, n_rows, nproc):
    assert _outcome(M.check_per_host_row_blocks, layout, n_rows, nproc) == \
        _outcome(JM.check_per_host_row_blocks, layout, n_rows, nproc)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_the_group_owns_contiguous_row_blocks(world):
    gm = M.GroupMesh(world)
    assert M.data_parallel_size(gm) == world == \
        JM.data_parallel_size(_Mesh(world))
    per = M._row_blocks_by_process(gm.devices_indices_map((world,)), world)
    assert per == {r: {r} for r in range(world)}
    M.assert_per_host_row_blocks(gm, world)
    M.assert_per_host_row_blocks()            # one process: nothing to do


ARGS = [(None, None, None), (None, 1, None), (None, 1, 0), (None, 2, None),
        (None, 2, 1), ("h:1", None, None), ("h:1", 2, None),
        ("h:1", None, 0), (None, 0, None), ("h:1", 0, 0)]


@pytest.mark.parametrize("args", ARGS)
def test_init_argument_checks_match_reference(args, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    ours = _outcome(launch_train.maybe_init_distributed, *args,
                    device="cpu")
    theirs = _outcome(j_launch.maybe_init_distributed, *args)
    assert (ours is None) == (theirs is None)
    head = "ValueError: multi-process launch needs all three of " \
           "coordinator address, num_processes and process_id"
    if ours is not None:
        assert ours.startswith(head) and theirs.startswith(head)
        assert ours.split("; got ")[1] == theirs.split("; got ")[1]
    else:
        assert launch_train.maybe_init_distributed(*args,
                                                   device="cpu") is False


def test_environment_stands_for_the_flags(monkeypatch):
    """torchrun's variables fill in missing flags, and a partial set
    raises as missing flags do."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="coordinator='127.0.0.1:1'"):
        launch_train.maybe_init_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.delenv("MASTER_ADDR")
    assert launch_train.maybe_init_distributed(device="cpu") is False
    assert launch_train.backend_for("cpu", 2) == "gloo"
    assert launch_train.backend_for("cuda", torch.cuda.device_count() + 1) \
        == "gloo"


@pytest.mark.parametrize("attempts,fail", [(1, 1), (4, 3), (4, 9), (3, 0)])
def test_init_retry_matches_reference(attempts, fail):
    def run(fn):
        calls, sleeps = [0], []

        def init():
            calls[0] += 1
            if calls[0] <= fail:
                raise RuntimeError("coordinator not up")
            return "ok"

        try:
            res = fn(init, attempts=attempts, backoff=0.5,
                     sleep=sleeps.append, log=lambda m: None)
        except RuntimeError as e:
            res = str(e)
        return calls[0], sleeps, res

    assert run(launch_train.init_distributed_with_retry) == \
        run(j_launch.init_distributed_with_retry)


# --------------------------------------------------------------------- #
# two ranks against one
# --------------------------------------------------------------------- #

KEYS = ("step", "tokens", "lr", "batch_size", "phase")


def _rows(hist):
    """A history without its host clock."""
    return [{k: v for k, v in h.items() if k != "wall"} for h in hist]


def _close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [a[k] for k in KEYS] == [b[k] for k in KEYS]
        assert abs(a["loss"] - b["loss"]) <= tol, (a, b)


def _params(tr):
    return {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}


def _weights_close(got, want, tol=1e-5):
    for n, w in want.items():
        scale = float(w.abs().max())
        assert float((got[n] - w).abs().max()) <= tol * scale, n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX ``Trainer``'s Seesaw run; the one-rank port run from its
    initial weights (saving at MID: ``ck1``); the two ranks' runs (the
    ``TRAIN`` script), started once ``ck1`` exists and run beside the
    rest; the one-rank adaptive run; the 2 -> 1 resume."""
    import repro.configs as JC
    import repro_torch.configs as C
    d = tmp_path_factory.mktemp("dist")
    jtr = JTrainer(run_cfg(JC), fuse_steps=FUSE, max_device_batch=MAX_DEV)
    model = from_jax_params(jax.tree.map(np.asarray, jtr.state.params),
                            run_cfg(C).model, dtype=torch.float32,
                            device="cpu")
    init = model.state_dict()
    torch.save(init, d / "init.pt")
    one = port_trainer("seesaw", init)
    one.run(port_loader(one, per_host=False), max_steps=MID)
    one.save_checkpoint(str(d / "ck1"))
    procs = _spawn(TRAIN, d)
    one.run(port_loader(one, one.state.tokens_seen, per_host=False))
    jtr.run(JLoader(JMarkovLM(512, seed=0), jtr.plan, SEQ))
    ad = port_trainer("adaptive-seesaw", init)
    ad.run(port_loader(ad, per_host=False), max_steps=ADAPT_STEPS)
    res = _wait(procs)
    for rc, o, e in res:
        assert rc == 0, e[-3000:]
    ranks = [torch.load(d / f"out{r}.pt") for r in range(2)]
    two_one = port_trainer("seesaw", init)
    two_one.restore_checkpoint(str(d / "ck2"), verify=True)
    two_one.run(port_loader(two_one, two_one.state.tokens_seen,
                            per_host=False))
    return dict(d=d, jtr=jtr, one=one, ad=ad, ranks=ranks,
                two_one=two_one)


def test_one_rank_run_matches_jax_trainer(runs):
    one, jtr = runs["one"], runs["jtr"]
    assert len(set(one.plan.batch_sizes())) == 2
    assert len(one.history) == len(jtr.history) == 17
    for a, b in zip(one.history, jtr.history):
        assert [a[k] for k in KEYS] == [b[k] for k in KEYS]
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) < 5e-4


def test_two_ranks_match_one_rank(runs):
    one = runs["one"]
    for rk in runs["ranks"]:
        run = rk["uninterrupted"]
        _close(run["history"], one.history)
        _weights_close(run["params"], _params(one))
    a, b = (rk["uninterrupted"] for rk in runs["ranks"])
    assert _rows(a["history"]) == _rows(b["history"])   # one run logged
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n])


def test_first_phase_is_bitwise_where_the_split_coincides(runs):
    """The saves at MID (phase 0): the two-rank checkpoint's blocks are
    the one-rank checkpoint's, byte for byte."""
    d = runs["d"]
    m1, m2 = _manifest(str(d / "ck1")), _manifest(str(d / "ck2"))
    for key, e in m1["arrays"].items():
        s1, s2 = e["shards"][0], m2["arrays"][key]["shards"][0]
        assert s1["crc32"] == s2["crc32"], key
    assert _rows(runs["ranks"][0]["uninterrupted"]["history"][:MID]) == \
        _rows(runs["one"].history[:MID])


def test_two_ranks_cut_where_one_rank_cuts(runs):
    want = runs["ad"].controller.cut_steps
    assert want == [8, 24]
    for rk in runs["ranks"]:
        run = rk["adaptive"]
        assert run["cut_steps"] == want
        _close(run["history"], runs["ad"].history)


def test_resume_2_to_2_is_bitwise(runs):
    for rk in runs["ranks"]:
        whole, res = rk["uninterrupted"], rk["resumed_2_2"]
        assert res["history"][0]["step"] == MID + 1
        assert len({h["batch_size"] for h in res["history"]}) == 2
        assert _rows(res["history"]) == _rows(whole["history"][MID:])
        for n, w in whole["params"].items():
            assert torch.equal(res["params"][n], w), n


def test_resume_2_to_1_and_1_to_2_stay_within_tolerance(runs):
    one, two_one = runs["one"], runs["two_one"]
    _close(two_one.history, one.history[MID:])
    _weights_close(_params(two_one), _params(one))
    for rk in runs["ranks"]:
        res = rk["resumed_1_2"]
        _close(res["history"], one.history[MID:])
        _weights_close(res["params"], _params(one))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_two_rank_checkpoint_bytes_writers_and_reference_restore(
        runs, monkeypatch):
    d, jtr = runs["d"], runs["jtr"]
    two = str(d / "ck2_final")
    # a one-rank save of the same state
    tr = port_trainer("seesaw", torch.load(d / "init.pt"))
    tr.restore_checkpoint(two)
    tr.save_checkpoint(str(d / "ck2_as_1"))
    m2, m1 = _manifest(two), _manifest(str(d / "ck2_as_1"))
    assert m2["meta"]["save_process_count"] == 2
    assert m1["meta"]["save_process_count"] == 1
    assert {k: v for k, v in m2["meta"].items() if k !=
            "save_process_count"} == \
        {k: v for k, v in m1["meta"].items() if k != "save_process_count"}
    assert m2["arrays"].keys() == m1["arrays"].keys()
    for key, e2 in m2["arrays"].items():
        s2, s1 = e2["shards"][0], m1["arrays"][key]["shards"][0]
        assert {k: v for k, v in s2.items() if k != "writer"} == \
            {k: v for k, v in s1.items() if k != "writer"}
        with open(os.path.join(two, s2["file"]), "rb") as f2, \
                open(os.path.join(str(d / "ck2_as_1"), s1["file"]),
                     "rb") as f1:
            assert f2.read() == f1.read(), key
    assert not [n for n in os.listdir(two) if n.startswith(".save-")]
    # the reference's writer rotation for two processes, over its leaves
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    flat = JCKPT._flat_state(jax.tree.map(np.asarray, jtr.state.params),
                             jax.tree.map(np.asarray, jtr.state.opt_state))
    arrays, _ = JCKPT._plan_writes(flat, m2["generation"])
    monkeypatch.undo()
    assert {k: [s["writer"] for s in e["shards"]]
            for k, e in arrays.items()} == \
        {k: [s["writer"] for s in e["shards"]]
         for k, e in m2["arrays"].items()}
    assert {s["writer"] for e in m2["arrays"].values()
            for s in e["shards"]} == {0, 1}
    # the reference restores the two-rank save
    import repro.configs as JC
    jres = JTrainer(run_cfg(JC), fuse_steps=FUSE, max_device_batch=MAX_DEV)
    meta = jres.restore_checkpoint(two, verify=True)
    assert (meta["step"], meta["save_process_count"]) == (STEPS - 3, 2)
    jflat = JCKPT._flat_state(jax.tree.map(np.asarray, jres.state.params),
                              jax.tree.map(np.asarray,
                                           jres.state.opt_state))
    for key, e2 in m2["arrays"].items():
        want = np.load(os.path.join(two, e2["shards"][0]["file"]))
        np.testing.assert_array_equal(np.asarray(jflat[key]), want)


def test_a_rank_killed_mid_save_leaves_the_previous_generation(
        runs, tmp_path):
    d = tmp_path
    torch.save(torch.load(runs["d"] / "init.pt"), d / "init.pt")
    res = _wait(_spawn(KILL, d))
    assert res[1][0] == -signal.SIGKILL, res[1][2][-2000:]
    rc, out, err = res[0]
    assert rc == 0, err[-2000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert "markers from processes [1] of generation 1" in \
        rec["timeout_error"]
    assert rec["committed_gen"] == 0
    assert rec["markers"] == [".save-1.0.json"]
    ck = str(d / "ck")
    tr = port_trainer("seesaw", torch.load(d / "init.pt"))
    meta = tr.restore_checkpoint(ck, verify=True)
    assert meta["step"] == 4
    gen0 = torch.load(d / "gen0.pt")
    for n, p in tr.state.model.named_parameters():
        assert torch.equal(p, gen0[n]), n
    # the next save clears the stale marker and the uncommitted blocks
    tr.save_checkpoint(ck)
    assert not [n for n in os.listdir(ck) if n.startswith(".save-")]
    assert os.listdir(os.path.join(ck, "arrays")) == ["1"]
    assert CKPT.read_meta(ck)["step"] == 4


LAUNCH = ["--device", "cpu", "--reduced", "--seq-len", "16",
          "--batch-size", "4", "--max-cuts", "1", "--fuse-steps", "2",
          "--total-tokens", str(16 * 4 * 400), "--steps", "300"]


def test_sigterm_to_one_rank_stops_both_at_one_boundary(tmp_path):
    ck = str(tmp_path / "ck")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--checkpoint", ck, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    lines = []
    for line in procs[0].stdout:
        lines.append(line)
        if line.startswith("step    10"):
            procs[1].send_signal(signal.SIGTERM)
            break
    outs = []
    for i, p in enumerate(procs):
        o, _ = p.communicate(timeout=120)
        outs.append(("".join(lines) if i == 0 else "") + o)
        assert p.returncode == 0, outs[-1][-3000:]
    steps = []
    for o in outs:
        stopped = [ln for ln in o.splitlines()
                   if ln.startswith("preemption signal")]
        assert stopped, o[-3000:]
        steps.append(int(stopped[0].split("step ")[1].split()[0]))
        assert "per-host data feeding forced on" in o
        assert "backend gloo" in o
    assert steps[0] == steps[1] and steps[0] % 2 == 0
    assert 10 <= steps[0] < 300
    meta = CKPT.read_meta(ck)
    assert (meta["step"], meta["save_process_count"]) == (steps[0], 2)


def test_torchrun_starts_the_group_from_its_environment(tmp_path):
    """Under torchrun the launcher takes MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE and RANK for the flags: two ranks train, log one run and
    save one two-process checkpoint."""
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", *LAUNCH[:-2], "--steps", "4",
         "--checkpoint", ck], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 2 and done[0] == done[1], out.stdout[-3000:]
    assert out.stdout.count("backend gloo") == 2
    meta = CKPT.read_meta(ck)
    assert (meta["step"], meta["save_process_count"]) == (4, 2)
