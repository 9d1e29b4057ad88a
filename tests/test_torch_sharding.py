"""The port's shard plan against the reference's, on the CPU.

- Spec trees: ``registry.param_specs`` of every registered arch (full
  and ``reduced()``, ``multi_pod`` and ``serve_resident`` both ways)
  equals the reference's leaf for leaf; ``input_shardings`` (every
  ``INPUT_SHAPES`` entry, ``multi_pod`` and ``cache_seq_shard`` both
  ways) and ``input_specs``' shapes too; ``opt_state_specs`` mirrors the
  params onto ``m``/``v``.
- Boxes: on the (2, 2) and (2, 1, 2) meshes, ``launch.mesh.shard_box``
  of every leaf of every arch, for rank r, equals the reference's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` for the
  device at position r of ``jax.make_mesh``'s ``devices`` array
  (computed in one subprocess with 4 forced host devices); and the
  port's own parameters (``parallel.leaf_specs`` through
  ``weights._ref_path``) get the reference leaf's block, its stacked
  layer dim dropped.
- The mesh: rank coordinates (model fastest), data slots, the groups'
  ranks, the launch / test / production shapes.
- Refusals, each a ``ValueError`` before any collective: a family other
  than dense, a head count or dim the mesh does not divide (MQA's one
  KV head at M=2), a mesh whose size is not the process count, and the
  launcher's ``--mesh`` with a non-dense arch.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import registry as JR
from repro.serving import cache as JSC
from repro.train import engine as JE
from repro_torch import parallel
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.serving import cache as SC
from repro_torch.train import engine as E
from repro_torch.train.trainer import Trainer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = list_archs()


def _cfgs(arch):
    return ((get_config(arch), j_get_config(arch)),
            (get_config(arch).reduced(), j_get_config(arch).reduced()))


def _flat(tree, prefix="", leaf=tuple):
    """{path: leaf(x)} over a tree of either package (dicts, lists, the
    two packages' DenseKVCache); by default a spec leaf as a tuple."""
    if isinstance(tree, (SC.DenseKVCache, JSC.DenseKVCache)):
        tree = {"data": tree.data, "lengths": tree.lengths}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/", leaf))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]/", leaf))
        return out
    return {prefix.rstrip("/"): leaf(tree)}


# --------------------------------------------------------------------- #
# spec trees
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    for cfg, jcfg in _cfgs(arch):
        for multi_pod in (False, True):
            for resident in (False, True):
                got = _flat(R.param_specs(cfg, multi_pod, resident))
                want = _flat(JR.param_specs(jcfg, multi_pod, resident))
                assert got == want, (cfg.name, multi_pod, resident)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shardings_and_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert set(INPUT_SHAPES) == set(J_INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_INPUT_SHAPES[name]
        for multi_pod in (False, True):
            for seq_shard in (False, True):
                got = _flat(R.input_shardings(cfg, shape, multi_pod,
                                              seq_shard))
                want = _flat(JR.input_shardings(jcfg, jshape, multi_pod,
                                                seq_shard))
                assert got == want, (name, multi_pod, seq_shard)
        ours = _flat(R.input_specs(cfg, shape), leaf=lambda t: t.shape)
        theirs = _flat(JR.input_specs(jcfg, jshape), leaf=lambda t: t.shape)
        for path in ("cache/data/ek", "cache/data/ev"):
            # the port stores the enc-dec's cross K/V (L, B, Hkv, Se, hd),
            # the decode kernel's layout; the reference (L, B, Se, Hkv, hd)
            if path in theirs:
                L, B, Se, H, hd = theirs[path]
                theirs[path] = (L, B, H, Se, hd)
        assert {k: tuple(v) for k, v in ours.items()} == \
            {k: tuple(v) for k, v in theirs.items()}, name


def test_opt_state_specs_mirror_the_params():
    cfg = get_config("llama3.2-3b")
    jcfg = j_get_config("llama3.2-3b")
    pspec = R.param_specs(cfg)
    got = E.opt_state_specs(pspec, {"m": 0, "v": 0, "count": 0})
    want = JE.opt_state_specs(JR.param_specs(jcfg),
                              {"m": 0, "v": 0, "count": 0})
    assert _flat(got) == _flat(want)
    assert tuple(got["count"]) == () == tuple(JP())


# --------------------------------------------------------------------- #
# boxes
# --------------------------------------------------------------------- #

BOXES = r'''
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config, list_archs
from repro.models import registry as R


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


out = {}
meshes = {"2x2": jax.make_mesh((2, 2), ("data", "model")),
          "2x1x2": jax.make_mesh((2, 1, 2), ("pod", "data", "model"))}
for arch in list_archs():
    for red in (False, True):
        cfg = get_config(arch).reduced() if red else get_config(arch)
        shapes = flat(jax.eval_shape(
            lambda: R.init_params(jax.random.PRNGKey(0), cfg)))
        for mname, mesh in meshes.items():
            specs = flat(R.param_specs(cfg, mname == "2x1x2"))
            for path, st in shapes.items():
                imap = NamedSharding(mesh, specs[path]).devices_indices_map(
                    st.shape)
                boxes = [[[s.start or 0, n if s.stop is None else s.stop]
                          for s, n in zip(imap[d], st.shape)]
                         for d in mesh.devices.flat]
                out[f"{cfg.name}|{mname}|{path}"] = [list(st.shape), boxes]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref_boxes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", BOXES], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


MESHES = {"2x2": M.make_test_mesh(2, 2),
          "2x1x2": M.make_test_mesh(1, 2, multi_pod=True)}


@pytest.mark.parametrize("arch", ARCHS)
def test_boxes_match_devices_indices_map(arch, ref_boxes):
    for cfg, _ in _cfgs(arch):
        for mname, mesh in MESHES.items():
            specs = _flat(R.param_specs(cfg, mname == "2x1x2"))
            n = 0
            for key, (shape, boxes) in ref_boxes.items():
                name, mn, path = key.split("|")
                if name != cfg.name or mn != mname:
                    continue
                n += 1
                even = all(len({b[d][1] - b[d][0] for b in boxes}) == 1
                           for d in range(len(shape)))
                if not even:        # GSPMD pads; the port refuses
                    with pytest.raises(ValueError, match="does not divide"):
                        M.shard_box(shape, specs[path], mesh, 0, name=path)
                    continue
                for r in range(4):
                    got = M.shard_box(shape, specs[path], mesh, r,
                                      name=path)
                    assert [list(b) for b in got] == boxes[r], (key, r)
            assert n == len(specs), (cfg.name, mname)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_parameters_get_the_reference_blocks(arch, ref_boxes):
    """Each port parameter's block (its spec from the reference path,
    the stacked layer entry dropped) is the reference leaf's block
    without the layer dim."""
    from repro_torch.weights import _ref_path
    cfg = get_config(arch).reduced()
    model = R.family(cfg).Model(cfg, dtype=torch.float32, device="meta")
    for mname, mesh in MESHES.items():
        specs = parallel.leaf_specs(model, cfg, mname == "2x1x2")
        for name, p in model.named_parameters():
            path, layer = _ref_path(name, cfg)
            _, boxes = ref_boxes[f"{cfg.name}|{mname}|{'/'.join(path)}"]
            for r in range(4):
                got = M.shard_box(tuple(p.shape), specs[name], mesh, r)
                want = boxes[r][1:] if layer is not None else boxes[r]
                assert [list(b) for b in got] == want, (name, r)


# --------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------- #

def test_mesh_coordinates_and_groups():
    m = M.make_test_mesh(2, 2)
    assert [m.coords(r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert [m.fsdp_index(r) for r in range(4)] == [0, 0, 1, 1]
    assert [m.fsdp_ranks(k) for k in range(2)] == [[0, 2], [1, 3]]
    assert [m.model_ranks(k) for k in range(2)] == [[0, 1], [2, 3]]
    p = M.make_test_mesh(2, 2, multi_pod=True)
    assert p.shape == {"pod": 2, "data": 2, "model": 2}
    assert [p.fsdp_index(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert p.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).size == 512
    assert M.make_launch_mesh(None) is None
    assert M.make_launch_mesh(None, distributed=True) is None
    assert M.make_launch_mesh("1x1").shape == {"data": 1, "model": 1}
    assert M.data_parallel_size(p) == 4 == p.n_fsdp


# --------------------------------------------------------------------- #
# refusals, before any collective
# --------------------------------------------------------------------- #

@pytest.fixture
def no_collective(monkeypatch):
    """Any collective or group made by the refused call fails the test."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective ran before the refusal")

    for name in ("new_group", "all_reduce", "all_gather", "barrier",
                 "init_process_group"):
        monkeypatch.setattr(dist, name, boom)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-medium", "internvl2-76b"])
def test_other_families_are_refused_on_a_mesh(arch, no_collective):
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match="dense family only"):
        parallel.check_model(cfg, M.make_test_mesh(2, 2))
    if R.has_frontend(cfg):        # the launcher refuses these anyway
        return
    with pytest.raises(ValueError, match="dense family only"):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--mesh", "2x2", "--steps", "1"])


def test_an_undivided_dim_or_head_count_is_refused(no_collective):
    llama = get_config("llama3.2-3b").reduced()
    mqa = ModelConfig(**{**llama.__dict__, "n_kv_heads": 1})
    with pytest.raises(ValueError, match=r"w_k: dim 1 holds 1 KV heads, "
                       r"which mesh axis 'model' of 2 does not divide"):
        parallel.check_model(mqa, M.make_test_mesh(1, 2))
    with pytest.raises(ValueError, match="query heads"):
        parallel.check_model(llama, M.make_test_mesh(1, 3))
    with pytest.raises(ValueError, match=r"tok: dim 1 of size 256 does not "
                       r"divide over mesh axis 'data' of 3"):
        parallel.check_model(llama, M.make_test_mesh(3, 1))


def test_a_mesh_that_is_not_the_process_count_is_refused(no_collective):
    cfg = get_config("seesaw-150m").reduced()
    with pytest.raises(ValueError, match="4 slots but the run has 1"):
        M.make_launch_mesh("2x2")
    with pytest.raises(ValueError, match="4 slots but the process group "
                       "has 1"):
        parallel.check(cfg, M.make_test_mesh(2, 2))
    from repro_torch.configs import (OptimizerConfig, RunConfig,
                                     ScheduleConfig)
    run = RunConfig(model=cfg, schedule=ScheduleConfig(kind="constant"),
                    optimizer=OptimizerConfig(), seq_len=16,
                    global_batch_size=4, total_tokens=640)
    with pytest.raises(ValueError, match="4 slots"):
        Trainer(run, device="cpu", mesh=M.make_test_mesh(2, 2))
    with pytest.raises(ValueError, match="DxM"):
        M.parse_mesh("2x2x2x2")


def test_shard_box_names_the_leaf_dim_and_axes():
    m = M.make_test_mesh(2, 2, multi_pod=True)
    assert M.shard_box((8, 6), (("pod", "data"), "model"), m, 5) == \
        ((4, 6), (3, 6))
    with pytest.raises(ValueError, match=r"lm_head: dim 0 of size 6 does "
                       r"not divide over mesh axis \('pod', 'data'\) of 4"):
        M.shard_box((6, 8), (("pod", "data"), "model"), m, 0,
                    name="lm_head")
    with pytest.raises(ValueError, match="does not have"):
        M.shard_box((8,), ("pod",), M.make_test_mesh(2, 2), 0)
    np.testing.assert_array_equal(
        [M.shard_box((4,), (None,), m, r) for r in range(8)],
        [((0, 4),)] * 8)
