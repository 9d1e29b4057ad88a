"""The port's checkpoints against the JAX package, on the CPU.

The on-disk format is the reference's v2 byte for byte: the port's
``train.checkpoint`` and ``repro.train.checkpoint`` write equal manifests
and equal ``.npy`` files for the same weights and optimizer state (dense
and the reduced mamba2), and each package resumes the other's training
run.  The format's own cases are the reference's
``tests/test_checkpoint_format.py`` and ``tests/test_checkpoint_manager.py``
on the port's state (its per-layer tensors written and read layer by
layer), less the multi-process ones; then resume inside the port, bit for
bit, and the launcher's save / stop / ``--resume``.

Tolerances: formats, restores and the port's own resumes bit for bit;
across packages the loss within 5e-4 of the reference's uninterrupted
run (``tests/test_torch_train.py``'s run tolerance), LR, batch and phase
equal.
"""
import dataclasses
import filecmp
import json
import os
import signal
import subprocess
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.models import registry as JR
from repro.optim import optimizers as JO
from repro.train import checkpoint as JC
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (ModelConfig, OptimizerConfig, RunConfig,
                                 ScheduleConfig, get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.launch import train as launch_train
from repro_torch.optim import optimizers as O
from repro_torch.train import checkpoint as C
from repro_torch.train.trainer import Trainer
from repro_torch.weights import (Stacked, from_jax_opt_state,
                                 from_jax_params, opt_tree, param_tree,
                                 to_jax_opt_state, to_jax_params)

ROOT = os.path.join(os.path.dirname(__file__), "..")

TINY = dict(name="ckpt-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=200,
            max_seq_len=64, rope_theta=1e4)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny models run thousands of small ops,
    which several test workers' thread pools on a shared CPU slow down
    many times over (and bit-for-bit comparisons need one thread count
    throughout)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg, make_opt=JO.adamw):
    """Reference params and optimizer state after one update (non-zero
    moments, count 1)."""
    p = jax.jit(lambda key: JR.init_params(key, jcfg))(
        jax.random.PRNGKey(0))
    opt = make_opt()
    o = opt.init(p)
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), p)
    p, o = jax.jit(opt.update)(g, o, p, jnp.float32(1e-3))
    return p, o


@pytest.fixture(scope="module")
def dense():
    p, o = _jax_state(JModelConfig(**TINY))
    return ModelConfig(**TINY), _np(p), _np(o)


def _state(dense):
    """A fresh port model and AdamW state holding the reference's
    values."""
    cfg, p, o = dense
    model = from_jax_params(p, cfg, dtype=torch.float32, device="cpu",
                            trainable=True)
    return model, from_jax_opt_state(o, model)


def _trees(state):
    model, opt_state = state
    return param_tree(model), opt_tree(model, opt_state)


def _zeros_like(state):
    model, opt_state = state
    z = from_jax_params(jax.tree.map(np.zeros_like, to_jax_params(model)),
                        model.cfg, dtype=torch.float32, device="cpu")
    zo = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
              if isinstance(v, dict) else torch.zeros_like(v))
          for k, v in opt_state.items()}
    return z, zo


def _leaves(state):
    return [t for t in C._flatten(C._flat_state(*_trees(state))).values()]


def _assert_states_equal(a, b):
    fa, fb = C._flat_state(*_trees(a)), C._flat_state(*_trees(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        xa = fa[k] if isinstance(fa[k], Stacked) else (fa[k],)
        xb = fb[k] if isinstance(fb[k], Stacked) else (fb[k],)
        for x, y in zip(xa, xb):
            assert x.dtype == y.dtype and torch.equal(x, y), k


def _bump(state, by=1.0):
    model, opt_state = state
    with torch.no_grad():
        for p in model.parameters():
            p.add_(by)
    return state


def _manifest(base):
    with open(os.path.join(base, "manifest.json")) as f:
        return json.load(f)


# --------------------------------------------------------------------- #
# the name map and the same bytes as the reference
# --------------------------------------------------------------------- #

OPTS = [("adamw", O.adamw, JO.adamw), ("adam", O.adam, JO.adam),
        ("sgd", O.sgd, JO.sgd), ("nsgd", O.nsgd, JO.nsgd)]


@pytest.mark.parametrize("name,ours,theirs", OPTS, ids=[o[0] for o in OPTS])
def test_name_map_round_trips_params_and_optimizer_state(dense, name, ours,
                                                         theirs):
    """``to_jax_params`` inverts ``from_jax_params``; the optimizer state
    maps both ways with the port's optimizer giving the same slots."""
    cfg, p, _ = dense
    jo = _np(theirs().init(jax.tree.map(jnp.asarray, p)))
    model = from_jax_params(p, cfg, dtype=torch.float32, device="cpu",
                            trainable=True)
    st = from_jax_opt_state(jo, model)
    want = ours().init(dict(model.named_parameters()))
    assert st.keys() == want.keys()
    assert st["count"].dtype == want["count"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(to_jax_params(model)),
                    jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    back = to_jax_opt_state(model, st)
    assert jax.tree.structure(back) == jax.tree.structure(jo)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["dense", "ssm", "moe", "hybrid",
                                    "encdec"])
def test_same_bytes_as_reference(tmp_path, family):
    """The reference's ``save`` and the port's, on the same weights and
    AdamW state: equal manifests (the same bytes, with no time in them)
    and every ``.npy`` byte for byte; each restores the other's.  The
    moe case is the reduced granite-moe-1b (``layers/moe/*`` leaves),
    the hybrid the reduced recurrentgemma at 5 layers (``groups/slot*``
    leaves stacked over one group, ``rem0``/``rem1`` unstacked), the
    encdec the reduced seamless-m4t-medium (``encoder/*`` stacked over
    its 12 layers, ``decoder/*`` over 2, ``enc_norm``)."""
    if family == "dense":
        jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    else:
        arch = {"ssm": "mamba2-2.7b", "moe": "granite-moe-1b-a400m",
                "hybrid": "recurrentgemma-9b",
                "encdec": "seamless-m4t-medium"}[family]
        jcfg = jget_config(arch).reduced()
        cfg = get_config(arch).reduced()
        if family == "hybrid":
            jcfg = dataclasses.replace(jcfg, n_layers=5)
            cfg = dataclasses.replace(cfg, n_layers=5)
    p, o = _jax_state(jcfg)
    model = from_jax_params(_np(p), cfg, dtype=torch.float32, device="cpu",
                            trainable=True)
    st = from_jax_opt_state(_np(o), model)
    meta = dict(phase=1, batch_size=8, schedule_kind="seesaw")
    JC.save(str(tmp_path / "j"), p, o, step=3, tokens_seen=2 ** 53 + 1,
            extra=meta)
    C.save(str(tmp_path / "t"), param_tree(model), opt_tree(model, st),
           step=3, tokens_seen=2 ** 53 + 1, extra=meta, chunk_bytes=1000)
    mj = (tmp_path / "j" / "manifest.json").read_bytes()
    mt = (tmp_path / "t" / "manifest.json").read_bytes()
    assert json.loads(mj) == json.loads(mt)
    assert mj == mt
    assert (tmp_path / "j" / "meta.json").read_bytes() == \
        (tmp_path / "t" / "meta.json").read_bytes()
    arrays = json.loads(mj)["arrays"]
    assert len(arrays) == 3 * len(jax.tree.leaves(p)) + 1   # p, m, v, count
    for entry in arrays.values():
        f = entry["shards"][0]["file"]
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    # each restores the other's, bit for bit
    z = _zeros_like((model, st))
    C.restore(str(tmp_path / "j"), *_trees(z), verify=True)
    _assert_states_equal(z, (model, st))
    jp, jo_, jmeta = JC.restore(str(tmp_path / "t"), p, o, verify=True)
    for a, b in zip(jax.tree.leaves((jp, jo_)), jax.tree.leaves((p, o))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jmeta["tokens_seen"] == 2 ** 53 + 1


# --------------------------------------------------------------------- #
# the directory format (tests/test_checkpoint_format.py)
# --------------------------------------------------------------------- #

class TestDirectoryFormat:
    def test_layout_and_roundtrip(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=3, tokens_seen=768)
        assert os.path.isfile(os.path.join(base, "meta.json"))
        manifest = _manifest(base)
        assert len(manifest["arrays"]) == len(_leaves(state))
        for entry in manifest["arrays"].values():
            assert len(entry["shards"]) == 1
            assert os.path.isfile(os.path.join(base,
                                               entry["shards"][0]["file"]))
        z = _zeros_like(state)
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 3 and meta["tokens_seen"] == 768
        _assert_states_equal(z, state)

    def test_restore_is_in_place(self, dense, tmp_path):
        """The restored values land in the given tensors (a trainer's
        captured graphs hold their addresses)."""
        state = _state(dense)
        C.save(str(tmp_path / "ck"), *_trees(state), step=1, tokens_seen=0)
        z = _zeros_like(state)
        ids = [id(t) for t in z[0].parameters()] + [id(z[1]["count"])]
        ptrs = [t.data_ptr() for t in z[0].parameters()]
        p2, o2, _ = C.restore(str(tmp_path / "ck"), *_trees(z))
        assert [id(t) for t in z[0].parameters()] + \
            [id(z[1]["count"])] == ids
        assert [t.data_ptr() for t in z[0].parameters()] == ptrs
        assert o2["count"] is z[1]["count"] and int(o2["count"]) == 1
        _assert_states_equal(z, state)

    def test_npz_suffix_is_stripped(self, dense, tmp_path):
        state = _state(dense)
        C.save(str(tmp_path / "ck.npz"), *_trees(state), step=1,
               tokens_seen=0)
        assert os.path.isdir(str(tmp_path / "ck"))
        z = _zeros_like(state)
        C.restore(str(tmp_path / "ck.npz"), *_trees(z))
        _assert_states_equal(z, state)

    def test_tokens_seen_int_exact_past_2_53(self, dense, tmp_path):
        state = _state(dense)
        big = 2 ** 53 + 1
        C.save(str(tmp_path / "ck"), *_trees(state), step=9,
               tokens_seen=big)
        _, _, meta = C.restore(str(tmp_path / "ck"), *_trees(state))
        assert meta["tokens_seen"] == big
        assert isinstance(meta["tokens_seen"], int)
        assert C.exact_tokens(meta["tokens_seen"]) == big
        assert C.exact_tokens(2816.0) == 2816

    def test_overwrite_replaces_generation(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=1, tokens_seen=10)
        assert os.listdir(os.path.join(base, "arrays")) == ["0"]
        _bump(state)
        C.save(base, *_trees(state), step=2, tokens_seen=20)
        assert os.listdir(os.path.join(base, "arrays")) == ["1"]
        z = _zeros_like(state)
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 2
        _assert_states_equal(z, state)

    def test_interrupted_save_keeps_previous_checkpoint(self, dense,
                                                        tmp_path,
                                                        monkeypatch):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=1, tokens_seen=10)
        first = _zeros_like(state)
        C.restore(base, *_trees(first))
        calls = {"n": 0}
        orig = C._stream_write

        def dying(*a, **kw):
            calls["n"] += 1
            if calls["n"] > 3:
                raise RuntimeError("simulated preemption")
            return orig(*a, **kw)

        monkeypatch.setattr(C, "_stream_write", dying)
        _bump(state)
        with pytest.raises(RuntimeError, match="preemption"):
            C.save(base, *_trees(state), step=2, tokens_seen=20)
        monkeypatch.setattr(C, "_stream_write", orig)
        z = _zeros_like(state)
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 1                      # old commit intact
        _assert_states_equal(z, first)
        C.save(base, *_trees(state), step=3, tokens_seen=30)
        assert os.listdir(os.path.join(base, "arrays")) == ["1"]
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 3
        _assert_states_equal(z, state)

    def test_missing_checkpoint_raises(self, dense, tmp_path):
        with pytest.raises(FileNotFoundError, match="manifest"):
            C.restore(str(tmp_path / "nope"), *_trees(_state(dense)))


class TestBoundedStreaming:
    def test_save_never_fetches_more_than_chunk(self, dense, tmp_path,
                                                monkeypatch):
        """Every device→host transfer goes through ``_to_host`` and moves
        at most ``chunk_bytes``."""
        state = _state(dense)
        sizes = []
        orig = C._to_host
        monkeypatch.setattr(C, "_to_host",
                            lambda x: sizes.append(orig(x).nbytes)
                            or orig(x))
        chunk = 1 << 12
        C.save(str(tmp_path / "ck"), *_trees(state), step=0, tokens_seen=0,
               chunk_bytes=chunk)
        tensors = [t for leaf in _leaves(state)
                   for t in (leaf if isinstance(leaf, Stacked) else (leaf,))]
        assert max(sizes) <= chunk
        assert sum(sizes) == sum(t.numel() * t.element_size()
                                 for t in tensors)
        assert len(sizes) > len(_leaves(state))

    def test_stacked_leaf_is_never_materialised(self, dense, tmp_path,
                                                monkeypatch):
        """With an unbounded chunk each transfer is one tensor of the
        port — one layer of a stacked leaf, never the stacked array —
        and a restore reads one layer's slice at a time."""
        state = _state(dense)
        sizes = []
        orig = C._to_host
        monkeypatch.setattr(C, "_to_host",
                            lambda x: sizes.append(orig(x).nbytes)
                            or orig(x))
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=0, tokens_seen=0,
               chunk_bytes=1 << 40)
        model, opt_state = state
        tensors = list(model.parameters())
        assert sorted(sizes) == sorted(
            [t.numel() * 4 for t in tensors] * 3 + [4])   # p, m, v, count
        reads = []
        orig_fill = C._fill_block
        monkeypatch.setattr(C, "_fill_block",
                            lambda out, box, blocks: reads.append(
                                out.nbytes) or orig_fill(out, box, blocks))
        C.restore(base, *_trees(_zeros_like(state)))
        assert max(reads) == max(t.numel() * 4 for t in tensors)
        stacked = sum(isinstance(leaf, Stacked) for leaf in _leaves(state))
        assert stacked and len(reads) == len(tensors) * 3

    def test_chunked_write_is_bitwise(self, dense, tmp_path):
        state = _state(dense)
        C.save(str(tmp_path / "a"), *_trees(state), step=0, tokens_seen=0,
               chunk_bytes=1 << 10)
        C.save(str(tmp_path / "b"), *_trees(state), step=0, tokens_seen=0)
        for entry in _manifest(str(tmp_path / "a"))["arrays"].values():
            f = entry["shards"][0]["file"]
            assert filecmp.cmp(tmp_path / "a" / f, tmp_path / "b" / f,
                               shallow=False)


class TestLegacyMigration:
    def test_legacy_npz_restores_through_new_path(self, dense, tmp_path):
        """A legacy ``.npz`` written by the reference's ``save_npz``
        restores into the port (and the port's ``save_npz`` writes the
        same arrays)."""
        state = _state(dense)
        _, p, o = dense
        base = str(tmp_path / "old")
        JC.save_npz(base, p, o, step=11, tokens_seen=2816.0)
        C.save_npz(str(tmp_path / "ours"), *_trees(state), step=11,
                   tokens_seen=2816.0)
        a, b = np.load(base + ".npz"), np.load(str(tmp_path / "ours.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
        z = _zeros_like(state)
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 11 and meta["tokens_seen"] == 2816.0
        _assert_states_equal(z, state)

    def test_new_save_retires_legacy_file(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save_npz(base, *_trees(state), step=1, tokens_seen=32.0)
        _bump(state, 2.0)
        C.save(base, *_trees(state), step=2, tokens_seen=64)
        assert not os.path.exists(base + ".npz")
        assert not os.path.exists(base + ".meta.json")
        z = _zeros_like(state)
        _, _, meta = C.restore(base, *_trees(z))
        assert meta["step"] == 2
        _assert_states_equal(z, state)
        os.remove(os.path.join(base, "manifest.json"))
        with pytest.raises(FileNotFoundError):
            C.restore(base, *_trees(z))


class TestChecksums:
    def test_manifest_carries_crc32_and_writer(self, dense, tmp_path):
        base = str(tmp_path / "ck")
        C.save(base, *_trees(_state(dense)), step=1, tokens_seen=32)
        man = _manifest(base)
        assert man["format"] == C.FORMAT_VERSION == JC.FORMAT_VERSION
        for entry in man["arrays"].values():
            for sh in entry["shards"]:
                assert isinstance(sh["crc32"], int)
                assert sh["writer"] == 0
                path = os.path.join(base, sh["file"])
                assert C._crc_of_file(path) == sh["crc32"] == \
                    JC._crc_of_file(path)

    def test_corrupt_block_raises_naming_it(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=1, tokens_seen=32)
        man = _manifest(base)
        victim = max(
            (sh for e in man["arrays"].values() for sh in e["shards"]),
            key=lambda sh: os.path.getsize(
                os.path.join(base, sh["file"])))["file"]
        fpath = os.path.join(base, victim)
        arr = np.load(fpath)
        arr.reshape(-1)[:4] += 1.0
        np.save(fpath, arr)
        z = _zeros_like(state)
        with pytest.raises(C.CheckpointCorruptionError) as ei:
            C.restore(base, *_trees(z), verify=True)
        assert victim in str(ei.value)
        # nothing was copied before the check failed
        assert all(not t.any() for t in z[0].parameters())
        C.restore(base, *_trees(z))                 # unverified: permissive

    def test_missing_block_raises_corruption_error(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=1, tokens_seen=32)
        victim = next(iter(_manifest(base)["arrays"].values()))
        os.remove(os.path.join(base, victim["shards"][0]["file"]))
        with pytest.raises(C.CheckpointCorruptionError,
                           match="missing on disk"):
            C.restore(base, *_trees(state), verify=True)

    @pytest.mark.parametrize("fault,exc", [
        ("shape", ValueError), ("missing-leaf", KeyError),
        ("missing-block", C.CheckpointCorruptionError),
        ("truncated-block", C.CheckpointCorruptionError)])
    def test_refused_restore_leaves_the_state(self, dense, tmp_path, fault,
                                              exc):
        """A checkpoint refused at its last leaf (without ``verify``)
        copies nothing: every leaf is checked before the first copy."""
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save(base, *_trees(state), step=1, tokens_seen=32)
        man = _manifest(base)
        # an optimizer leaf: restored after every parameter
        key = [k for k, e in man["arrays"].items()
               if k.startswith("o:") and e["shape"]][-1]
        fpath = os.path.join(base, man["arrays"][key]["shards"][0]["file"])
        if fault == "shape":
            man["arrays"][key]["shape"][-1] += 1
        elif fault == "missing-leaf":
            del man["arrays"][key]
        elif fault == "missing-block":
            os.remove(fpath)
        else:
            with open(fpath, "r+b") as f:
                f.truncate(os.path.getsize(fpath) // 2)
        with open(os.path.join(base, "manifest.json"), "w") as f:
            json.dump(man, f)
        z = _zeros_like(state)
        with pytest.raises(exc, match=key):
            C.restore(base, *_trees(z))
        assert all(not t.any() for t in z[0].parameters())
        assert all(not t.any() for v in z[1].values()
                   for t in (v.values() if isinstance(v, dict) else [v]))

    def test_legacy_npz_verify_warns_not_crashes(self, dense, tmp_path):
        state = _state(dense)
        base = str(tmp_path / "ck")
        C.save_npz(base, *_trees(state), step=1, tokens_seen=32.0)
        with pytest.warns(UserWarning, match="no.*checksums"):
            C.restore(base, *_trees(state), verify=True)


@pytest.mark.parametrize("value", [2816, 2 ** 60 + 1, 2816.0, 2816.3,
                                   float(2 ** 54)])
def test_exact_tokens_matches_reference(value):
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        got = C.exact_tokens(value)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = JC.exact_tokens(value)
    assert got == want and type(got) is int
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]


# --------------------------------------------------------------------- #
# the async manager (tests/test_checkpoint_manager.py)
# --------------------------------------------------------------------- #

def _gated(monkeypatch):
    gate = threading.Event()
    orig = C._stream_write

    def gated(p, data, chunk_bytes):
        gate.wait(timeout=30)
        return orig(p, data, chunk_bytes)

    monkeypatch.setattr(C, "_stream_write", gated)
    return gate


def test_async_save_commits_and_matches_sync(dense, tmp_path):
    state = _state(dense)
    mgr = C.CheckpointManager()
    a, s = str(tmp_path / "async"), str(tmp_path / "sync")
    mgr.request_save(a, *_trees(state), step=7, tokens_seen=123,
                     block=True)
    mgr.finalize()
    C.save(s, *_trees(state), step=7, tokens_seen=123)
    assert (tmp_path / "async" / "manifest.json").read_bytes() == \
        (tmp_path / "sync" / "manifest.json").read_bytes()
    z = _zeros_like(state)
    _, _, meta = C.restore(a, *_trees(z), verify=True)
    _assert_states_equal(z, state)
    assert meta["step"] == 7


def test_overlapping_requests_coalesce_to_newest(dense, tmp_path,
                                                 monkeypatch):
    state = _state(dense)
    path = str(tmp_path / "ck")
    gate = _gated(monkeypatch)
    mgr = C.CheckpointManager()
    for step in (1, 2, 3):
        mgr.request_save(path, *_trees(state), step=step,
                         tokens_seen=10 * step)
    gate.set()
    mgr.finalize()
    assert mgr.saves_started == mgr.saves_committed == 2
    man = _manifest(path)
    assert man["meta"]["step"] == 3 and man["meta"]["tokens_seen"] == 30
    assert os.listdir(os.path.join(path, "arrays")) == \
        [str(man["generation"])]


def test_writer_error_reraised_then_cleared(dense, tmp_path, monkeypatch):
    state = _state(dense)
    path = str(tmp_path / "ck")

    def failing(p, data, chunk_bytes):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(C, "_stream_write", failing)
    mgr = C.CheckpointManager()
    mgr.request_save(path, *_trees(state), step=1, tokens_seen=10)
    mgr.wait()
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.check()
    mgr.check()                         # surfaced once, not latched
    monkeypatch.undo()
    mgr.request_save(path, *_trees(state), step=2, tokens_seen=20,
                     block=True)
    mgr.finalize()
    assert _manifest(path)["meta"]["step"] == 2


def test_writer_error_surfaces_on_finalize(dense, tmp_path, monkeypatch):
    def failing(p, data, chunk_bytes):
        raise OSError("enospc")

    monkeypatch.setattr(C, "_stream_write", failing)
    mgr = C.CheckpointManager()
    mgr.request_save(str(tmp_path / "ck"), *_trees(_state(dense)), step=1,
                     tokens_seen=10)
    with pytest.raises(OSError, match="enospc"):
        mgr.finalize()


def test_gc_never_deletes_last_committed_generation(dense, tmp_path,
                                                    monkeypatch):
    state = _state(dense)
    path = str(tmp_path / "ck")
    mgr = C.CheckpointManager()
    mgr.request_save(path, *_trees(state), step=1, tokens_seen=10,
                     block=True)
    gen0 = _manifest(path)["generation"]
    calls = {"n": 0}
    orig = C._stream_write

    def fail_late(p, data, chunk_bytes):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("died mid-save")
        return orig(p, data, chunk_bytes)

    monkeypatch.setattr(C, "_stream_write", fail_late)
    mgr.request_save(path, *_trees(state), step=2, tokens_seen=20)
    mgr.wait()
    with pytest.raises(OSError, match="died mid-save"):
        mgr.check()
    monkeypatch.undo()
    assert _manifest(path)["generation"] == gen0
    assert os.path.isdir(os.path.join(path, "arrays", str(gen0)))
    _, _, meta = C.restore(path, *_trees(_zeros_like(state)), verify=True)
    assert meta["step"] == 1
    mgr.request_save(path, *_trees(state), step=3, tokens_seen=30,
                     block=True)
    mgr.finalize()
    man = _manifest(path)
    assert man["generation"] == gen0 + 1 and man["meta"]["step"] == 3
    assert os.listdir(os.path.join(path, "arrays")) == [str(gen0 + 1)]


def test_snapshot_isolated_from_in_place_updates(dense, tmp_path,
                                                 monkeypatch):
    """The snapshot holds its own copy: the training step updates the
    live tensors in place (a graph replay) while the writer streams.
    Simulated by gating the writer and changing every live tensor."""
    state = _state(dense)
    before = _zeros_like(state)
    for a, b in zip(_leaves(before), _leaves(state)):
        for x, y in zip(*(v if isinstance(v, Stacked) else (v,)
                          for v in (a, b))):
            x.data.copy_(y)
    path = str(tmp_path / "ck")
    gate = _gated(monkeypatch)
    mgr = C.CheckpointManager()
    mgr.request_save(path, *_trees(state), step=1, tokens_seen=10)
    _bump(state, 5.0)
    state[1]["count"].add_(7)
    for t in state[1]["m"].values():
        t.mul_(-1)
    gate.set()
    mgr.finalize()
    z = _zeros_like(state)
    C.restore(path, *_trees(z), verify=True)
    _assert_states_equal(z, before)


# --------------------------------------------------------------------- #
# training runs: across packages, and resume inside the port
# --------------------------------------------------------------------- #

SEQ = 32


def _ramp_cfg(ours: bool, **kw):
    M, Sch, Opt, Run = ((ModelConfig, ScheduleConfig, OptimizerConfig,
                         RunConfig) if ours else
                        (JModelConfig, JScheduleConfig, JOptimizerConfig,
                         JRunConfig))
    return Run(model=M(**dict(TINY, vocab_size=128)),
               schedule=Sch(kind="seesaw", base_lr=1e-3, alpha=2.0,
                            n_cuts=2),
               optimizer=Opt(), seq_len=SEQ, global_batch_size=4,
               total_tokens=SEQ * 4 * 12, dtype="float32", remat=False,
               **kw)


def _port_from(jtr):
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    model = from_jax_params(_np(jtr.state.params), tr.cfg.model,
                            dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    return tr


def _port_loader(tr, tokens=0):
    return PhaseDataLoader(MarkovLM(128, seed=0), tr.plan, SEQ,
                           device="cpu").resume(tokens)


KEYS = ("step", "tokens", "lr", "batch_size", "phase", "loss", "grad_norm")


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The reference's uninterrupted run, saving at MID (the chunk
    boundary where phase 0 ends: the save records phase 1, B=8) as it
    goes; the port resumed from that save; the port run to MID from the
    same weights and saved; the reference resumed from the port's
    save."""
    d = tmp_path_factory.mktemp("cross")
    jtr = JTrainer(_ramp_cfg(False), fuse_steps=4)
    mid = jtr.plan.steps_per_phase(SEQ)[0]
    port = _port_from(jtr)                    # before jtr trains
    jpath = str(d / "jax")

    def save_at_mid():
        if jtr.state.step == mid:
            jtr.save_checkpoint(jpath)
        return False

    jtr.run(JLoader(JMarkovLM(128, seed=0), jtr.plan, SEQ),
            stop_fn=save_at_mid)

    resumed = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    assert resumed.restore_checkpoint(jpath, verify=True)["phase"] == 1
    resumed.run(_port_loader(resumed, resumed.state.tokens_seen))

    tpath = str(d / "port")
    port.run(_port_loader(port), max_steps=mid)
    port.save_checkpoint(tpath)
    jres = JTrainer(_ramp_cfg(False), fuse_steps=4)
    jres.restore_checkpoint(tpath, verify=True)
    jres.run(JLoader(JMarkovLM(128, seed=0), jres.plan, SEQ,
                     validate=False).resume(jres.state.tokens_seen))
    return jtr, mid, resumed, jres


def _same_run(got, want, loss_tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
        assert abs(a["loss"] - b["loss"]) <= loss_tol


def test_jax_save_resumes_in_the_port(cross):
    jtr, mid, resumed, _ = cross
    assert resumed.history[0]["step"] == mid + 1
    assert len({h["batch_size"] for h in resumed.history}) >= 2
    _same_run(resumed.history, jtr.history[mid:], 5e-4)
    assert resumed.state.tokens_seen == jtr.state.tokens_seen


def test_port_save_resumes_in_jax(cross):
    jtr, mid, _, jres = cross
    assert jres.history[0]["step"] == mid + 1
    _same_run(jres.history, jtr.history[mid:], 5e-4)
    assert jres.state.step == jtr.state.step


@pytest.fixture(scope="module")
def port_full():
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    tr.run(_port_loader(tr))
    return tr


@pytest.mark.parametrize("async_save", [True, False])
def test_port_resume_is_bitwise(port_full, tmp_path, async_save):
    """Saves every 4 steps and a stop at step 8 (a chunk boundary inside
    phase 1); a fresh trainer restores with ``verify=True`` and ends on
    the uninterrupted run's history and state bit for bit."""
    path = str(tmp_path / "ck")
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    tr.run(_port_loader(tr), checkpoint_path=path, save_every=4,
           async_save=async_save, stop_fn=lambda: tr.state.step >= 8)
    tr.close()
    assert tr.state.step == 8
    tr2 = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    meta = tr2.restore_checkpoint(path, verify=True)
    assert (meta["step"], meta["phase"]) == (8, 1)
    tr2.run(_port_loader(tr2, tr2.state.tokens_seen))
    assert [[h[k] for k in KEYS] for h in tr.history + tr2.history] == \
        [[h[k] for k in KEYS] for h in port_full.history]
    _assert_states_equal((tr2.state.model, tr2.state.opt_state),
                         (port_full.state.model, port_full.state.opt_state))


def test_phase_mismatch_raises_and_leaves_the_state(port_full, tmp_path):
    """A plan that puts the saved tokens in another phase is refused
    before any tensor is touched."""
    path = str(tmp_path / "ck")
    port_full.save_checkpoint(path)
    cfg = _ramp_cfg(True)
    other = dataclasses.replace(cfg, total_tokens=cfg.total_tokens * 4)
    tr = Trainer(other, device="cpu")
    before = [p.clone() for p in tr.state.model.parameters()]
    with pytest.raises(ValueError, match="schedule mismatch"):
        tr.restore_checkpoint(path)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tr.state.model.parameters()))


def test_trainer_resumes_from_legacy_float_checkpoint(port_full, tmp_path):
    """A mid-ramp legacy ``.npz`` (float ``tokens_seen``) resumes through
    ``Trainer.restore_checkpoint`` on the uninterrupted run bit for
    bit."""
    tr = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    mid = tr.plan.steps_per_phase(SEQ)[0] + 1
    tr.run(_port_loader(tr), max_steps=mid)
    ph = tr.plan.realized_phase_at(tr.state.tokens_seen, SEQ)
    path = str(tmp_path / "old.npz")
    C.save_npz(path, *_trees((tr.state.model, tr.state.opt_state)),
               tr.state.step, float(tr.state.tokens_seen),
               extra={"phase": ph.index, "batch_size": ph.batch_size,
                      "schedule_kind": tr.plan.kind,
                      "total_tokens": tr.plan.total_tokens})
    tr2 = Trainer(_ramp_cfg(True), device="cpu", fuse_steps=4)
    meta = tr2.restore_checkpoint(path)
    assert isinstance(tr2.state.tokens_seen, int)
    assert meta["phase"] == ph.index >= 1
    tr2.run(_port_loader(tr2, tr2.state.tokens_seen))
    assert [[h[k] for k in KEYS] for h in tr2.history] == \
        [[h[k] for k in KEYS] for h in port_full.history[mid:]]


# --------------------------------------------------------------------- #
# the launcher: save, stop, --resume
# --------------------------------------------------------------------- #

LAUNCH = ["--device", "cpu", "--reduced", "--seq-len", "16",
          "--batch-size", "2", "--max-cuts", "2", "--fuse-steps", "4",
          "--total-tokens", str(16 * 2 * 40)]


def _strip(hist):
    return [[h[k] for k in KEYS] for h in hist]


@pytest.fixture(scope="module")
def launch_once():
    return launch_train.main(LAUNCH)


def test_launcher_save_every_then_resume_is_one_run(launch_once, tmp_path,
                                                    capsys):
    path = str(tmp_path / "ck")
    first = launch_train.main(LAUNCH + ["--steps", "12", "--checkpoint",
                                        path, "--save-every", "4"])
    rest = launch_train.main(LAUNCH + ["--checkpoint", path, "--resume",
                                       "--verify-restore"])
    out = capsys.readouterr().out
    assert "resumed step 12" in out and "checkpoint →" in out
    assert [h["step"] for h in first] == list(range(1, 13))
    assert _strip(first + rest) == _strip(launch_once)


def test_launcher_sigterm_stops_on_a_chunk_boundary_and_resumes(
        launch_once, tmp_path):
    path = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--checkpoint", path], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("step    10"):
            proc.send_signal(signal.SIGTERM)
            break
    out, _ = proc.communicate(timeout=120)
    out = "".join(lines) + out
    assert proc.returncode == 0, out
    stopped = [ln for ln in out.splitlines()
               if ln.startswith("preemption signal")]
    assert stopped, out
    step = int(stopped[0].split("step ")[1].split()[0])
    assert step % 4 == 0 and 10 <= step < len(launch_once)
    assert C.read_meta(path)["step"] == step
    rest = launch_train.main(LAUNCH + ["--checkpoint", path, "--resume"])
    assert _strip(rest) == _strip(launch_once[step:])
