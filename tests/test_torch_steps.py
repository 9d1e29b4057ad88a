"""``repro_torch.launch.steps`` and the rank-only init against the
reference, in this process (``build_workload`` allocates nothing).

- ``build_workload``'s in and out spec trees equal the reference's for
  every registered arch × {train_4k, prefill_32k, decode_32k, long_500k}
  × ``multi_pod`` × ``serve_resident`` × ``cache_seq_shard`` (the
  enc-dec's cross K/V by the logical dim each entry cuts); its args are
  meta-device stand-ins; ``block_skip``, whose path the port lacks, is
  refused; ``seq_shard`` (default True, the reference's) and
  ``remat_policy="dots"`` are taken for every arch and shape
  ``shape_supported`` admits.
- ``shape_supported`` agrees with the reference on every arch and shape.
- ``validate_feeding`` passes and raises where the reference's does, with
  the same messages, on the same plans (whole ramps and elastic resumes),
  and feeds a data × model mesh by its data slots.
- ``registry.init_model(mesh=, rank=)`` keeps, for every rank of a 2x2
  and a 1x4 mesh and every family, bitwise the blocks that
  ``init_model`` followed by ``parallel.shard`` keeps (train and
  ``serve_resident`` specs).  No process group is needed: the groups are
  made at the first collective, which neither path calls, so the test
  gives ``launch.mesh.world_size`` the mesh's size.
"""
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.core.seesaw import build_plan as j_build_plan
from repro.launch import steps as JST
from repro_torch import parallel
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.core.seesaw import build_plan
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import registry as R
from repro_torch.models.layers import P
from test_torch_sharding import _flat, by_logical_dims

ARCHS = list_archs()
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(specs):
    """An out-spec (one spec, or a tuple of spec trees) as a list."""
    return [specs] if isinstance(specs, (P, JP)) else list(specs)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_workload_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        for multi_pod in (False, True):
            for resident in (False, True):
                for seq_cut in (False, True):
                    kw = dict(multi_pod=multi_pod, serve_resident=resident,
                              cache_seq_shard=seq_cut)
                    _, args, ins, outs = ST.build_workload(
                        cfg, INPUT_SHAPES[name], **kw)
                    _, _, jins, jouts = JST.build_workload(
                        jcfg, J_INPUT_SHAPES[name], **kw)
                    where = (name, kw)
                    assert by_logical_dims(_flat(list(ins)), "port") == \
                        by_logical_dims(_flat(list(jins)), "ref"), where
                    assert by_logical_dims(_flat(_seq(outs)), "port") == \
                        by_logical_dims(_flat(_seq(jouts)), "ref"), where
                    assert len(args) == len(ins), where
                    metas = [t for a in args[1:] for t in _flat(
                        a, leaf=lambda x: x).values()]
                    metas += list(args[0].parameters())
                    assert all(t.device.type == "meta" for t in metas), where


def test_build_workload_refuses_paths_it_does_not_have():
    """``block_skip`` is the one knob refused; ``seq_shard`` and
    ``remat_policy`` have their paths now (``test_build_workload_takes_
    the_reference_knobs``)."""
    cfg = get_config("llama3.2-3b")
    for shape in ("train_4k", "prefill_32k"):
        with pytest.raises(NotImplementedError, match="block_skip"):
            ST.build_workload(cfg, INPUT_SHAPES[shape], block_skip=True)


def test_serving_steps_refuse_a_model_held_in_another_dtype():
    cfg = get_config("llama3.2-3b").reduced()
    fn, args, _, _ = ST.build_workload(cfg, INPUT_SHAPES["decode_32k"],
                                       dtype=torch.bfloat16)
    model = R.init_model(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="weights' dtype"):
        fn(model, args[1], args[2])


def test_shape_supported_agrees_with_the_reference():
    assert ST.LONG_CONTEXT_ARCHS == JST.LONG_CONTEXT_ARCHS
    for arch in ARCHS:
        for name, shape in INPUT_SHAPES.items():
            assert ST.shape_supported(get_config(arch), shape) == \
                JST.shape_supported(j_get_config(arch),
                                    J_INPUT_SHAPES[name]), (arch, name)


def _plans():
    """The same ramp in both packages: batches 8, 16, 32."""
    kw = dict(kind="seesaw", base_lr=1e-3, total_tokens=SEQ * 8 * 24,
              warmup_frac=0.0, b0=8, alpha=2.0, n_cuts=2)
    return build_plan(**kw), j_build_plan(**kw)


def _outcome(fn):
    try:
        fn()
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("procs", [1, 2, 4, 8, 16, 64])
def test_validate_feeding_passes_and_raises_where_the_reference_does(procs):
    plan, jplan = _plans()
    steps = plan.steps_per_phase(SEQ)
    assert steps == jplan.steps_per_phase(SEQ)
    starts = (None, 2 * 8 * SEQ, steps[0] * 8 * SEQ,
              (steps[0] * 8 + steps[1] * 16) * SEQ)
    for start in starts:
        for seq in (SEQ, None):
            kw = dict(process_count=procs, start_tokens=start, seq_len=seq)
            got = _outcome(lambda: ST.validate_feeding(plan, None, **kw))
            want = _outcome(lambda: JST.validate_feeding(jplan, None, **kw))
            assert got == want, kw


def test_validate_feeding_on_a_mesh_of_processes_feeds_by_data_slot():
    plan, _ = _plans()
    assert ST.validate_feeding(plan, M.make_test_mesh(4, 2)) is plan
    with pytest.raises(ValueError, match="phase 0.*16 host"):
        ST.validate_feeding(plan, M.Mesh({"data": 16, "model": 2}))
    with pytest.raises(ValueError, match="phase 0.*16 data"):
        ST.validate_feeding(plan, M.Mesh({"data": 16, "model": 2}),
                            process_count=2)


INIT_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b",
              "recurrentgemma-9b", "seamless-m4t-medium", "internvl2-76b")


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_rank_only_init_is_bitwise_init_and_shard(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    for spec in ("2x2", "1x4"):
        mesh = M.Mesh(M.parse_mesh(spec))
        monkeypatch.setattr(M, "world_size", lambda: mesh.size)
        for resident in (False, True):
            for r in range(mesh.size):
                want = R.init_model(cfg, seed=7, dtype=torch.float32,
                                    device="cpu")
                parallel.shard(want, cfg, mesh, r, serve_resident=resident)
                got = R.init_model(cfg, seed=7, dtype=torch.float32,
                                   device="cpu", mesh=mesh, rank=r,
                                   serve_resident=resident)
                a, b = dict(want.named_parameters()), dict(
                    got.named_parameters())
                assert list(a) == list(b)
                for n in a:
                    assert torch.equal(a[n], b[n]), (spec, resident, r, n)
                    assert not hasattr(b[n], "whole")
                assert got.boxes == want.boxes
                assert got.full_shapes == want.full_shapes
                assert got.serve_resident is resident
                assert got.tp.rank == r


@pytest.mark.parametrize("arch", ARCHS)
def test_build_workload_takes_the_reference_knobs(arch):
    """``seq_shard=True`` (the default, as the reference's) and
    ``remat_policy="dots"`` build every mode ``shape_supported`` admits,
    with the reference's spec trees."""
    import inspect
    sig = inspect.signature(ST.build_workload).parameters
    jsig = inspect.signature(JST.build_workload).parameters
    for knob in ("seq_shard", "remat_policy", "block_skip"):
        assert sig[knob].default == jsig[knob].default, knob
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        if not ST.shape_supported(cfg, INPUT_SHAPES[name])[0]:
            continue
        kw = dict(seq_shard=True, remat_policy="dots")
        _, _, ins, outs = ST.build_workload(cfg, INPUT_SHAPES[name], **kw)
        _, _, jins, jouts = JST.build_workload(jcfg, J_INPUT_SHAPES[name],
                                               **kw)
        assert by_logical_dims(_flat(list(ins)), "port") == \
            by_logical_dims(_flat(list(jins)), "ref"), name
        assert by_logical_dims(_flat(_seq(outs)), "port") == \
            by_logical_dims(_flat(_seq(jouts)), "ref"), name


FN_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "internvl2-76b",
            "mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", FN_ARCHS)
def test_train_and_prefill_fns_equal_the_reference_on_one_device(arch):
    """The train step's loss (``seq_shard=True``, ``remat_policy="dots"``)
    within 1e-5 of the reference's step's, and the prefill's logits within
    2e-5 of the reference's largest, float32, on one device (the reduced
    config, 2 x 32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import OptimizerConfig as JOptimizerConfig
    from repro.configs.base import InputShape as JInputShape
    from repro.models import registry as JR
    from repro.optim import optimizers as JO
    from repro_torch.configs import OptimizerConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.optim import optimizers as O
    from repro_torch.weights import from_jax_params
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    params = JR.init_params(jax.random.PRNGKey(3), jcfg)
    npp = jax.tree.map(np.asarray, params)
    knobs = dict(seq_shard=True, remat_policy="dots")
    got, want = {}, {}
    for mode in ("train", "prefill"):
        batch = {k: np.array(v, dtype=np.float32 if v.dtype != jnp.int32
                               else np.int32)
                 for k, v in JR.concrete_inputs(jcfg, mode, 2, 32).items()}
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        fn = ST.build_workload(cfg, InputShape("s", 32, 2, mode),
                               dtype=torch.float32, **knobs)[0]
        jfn = jax.jit(JST.build_workload(
            jcfg, JInputShape("s", 32, 2, mode), dtype=jnp.float32,
            **knobs)[0])
        model = from_jax_params(npp, cfg, dtype=torch.float32, device="cpu",
                                trainable=mode == "train")
        if mode == "train":
            opt = O.from_config(OptimizerConfig(kind="adamw"))
            jopt = JO.from_config(JOptimizerConfig(kind="adamw"))
            got[mode] = float(fn(model, opt.init(dict(
                model.named_parameters())), tb, torch.tensor(1e-3))[2])
            want[mode] = float(jfn(params, jopt.init(params), jb,
                                   jnp.float32(1e-3))[2])
        else:
            got[mode] = fn(model, tb).detach().numpy()
            want[mode] = np.asarray(jfn(params, jb))
    assert abs(got["train"] - want["train"]) <= 1e-5
    assert np.abs(got["prefill"] - want["prefill"]).max() <= \
        2e-5 * np.abs(want["prefill"]).max()
