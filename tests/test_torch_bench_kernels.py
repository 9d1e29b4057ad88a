"""The port's kernel benchmark (``repro_torch.bench.kernels``) and the
plain version of its overlap probe against the reference's
``benchmarks/bench_kernels.py``.

- ``kernels.ref.overlap_norm_ref`` against the reference's Pallas
  ``_overlap_call`` in interpret mode, on the same numpy inputs, within
  2e-5 (float32, ``docs/kernels.md``).
- The benchmark's configs, analytic columns and CSV names against the
  reference's sweeps (run with their timer stubbed, so nothing is timed
  or compiled) and against ``artifacts/bench_kernels.json``.
- The CLI on the CPU, and its refusal of the card's default without one.

The overlap kernel itself runs only on the card:
``tests/test_torch_card.py``.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:                # the reference's benchmarks/
    sys.path.insert(0, ROOT)

from benchmarks import bench_kernels as jbk  # noqa: E402
from repro_torch.bench import kernels as BK  # noqa: E402
from repro_torch.kernels import overlap as OV  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
SECTIONS = ("attention", "rmsnorm", "ssd")


@pytest.mark.parametrize("rows,d,block,depth", [
    (2048, 256, 128, 1), (2048, 256, 128, 2),
    (2048, 256, 256, 1), (2048, 256, 256, 2),
    (512, 64, 64, 4), (512, 64, 64, 8),     # depth 8: every row-block
    (512, 64, 128, 4), (512, 64, 128, 8),   # deeper than the row-blocks
])
def test_overlap_norm_ref_matches_reference_kernel(rows, d, block, depth):
    x = np.random.default_rng(rows + block + depth).standard_normal(
        (rows, d)).astype(np.float32)
    want = np.asarray(jbk._overlap_call(jnp.asarray(x), block=block,
                                        depth=depth, interpret=True))
    got = ref.overlap_norm_ref(torch.from_numpy(x))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.from_numpy(want.copy()), **F32)


def _reference_rows(monkeypatch, ci):
    """The reference's sweeps with their timer stubbed: configs and
    analytic columns, nothing timed or compiled."""
    monkeypatch.setattr(jbk, "_time_ms", lambda fn, *a, **k: 1.0)
    return {"attention": jbk._attention_sweep("xla", ci),
            "rmsnorm": jbk._rmsnorm_sweep("xla", ci),
            "ssd": jbk._ssd_sweep("xla", ci)}


def _analytics(section, cfg):
    if section == "attention":
        a = BK.attention_analytics(*cfg[:5])
        return {"gflops_fwd": a["gflops_fwd"],
                "flops_per_byte": a["flops_per_byte"]}
    if section == "ssd":
        return BK.ssd_analytics(*cfg)
    return {}


@pytest.mark.parametrize("ci", [True, False])
def test_configs_and_analytics_match_reference_sweeps(monkeypatch, ci):
    want = _reference_rows(monkeypatch, ci)
    port = {"attention": BK.ATTENTION[ci], "rmsnorm": BK.RMSNORM[ci],
            "ssd": BK.SSD[ci]}
    for section in SECTIONS:
        keys = BK.CONFIG_KEYS[section]
        assert [tuple(r[k] for k in keys) for r in want[section]] \
            == port[section]
        for r, cfg in zip(want[section], port[section]):
            for k, v in _analytics(section, cfg).items():
                assert v == r[k], (section, cfg, k)


def test_analytics_match_reference_artifact():
    with open(os.path.join(ROOT, "artifacts", "bench_kernels.json")) as f:
        art = json.load(f)
    for section in SECTIONS:
        keys = BK.CONFIG_KEYS[section]
        cfgs = [tuple(r[k] for k in keys) for r in art[section]]
        assert cfgs == getattr(BK, section.upper())[False]
        for r, cfg in zip(art[section], cfgs):
            for k, v in _analytics(section, cfg).items():
                assert v == r[k], (section, cfg, k)
    # RMSNorm's bytes: the reference's gb_per_s over its own time
    for r in art["rmsnorm"]:
        gb = BK.rmsnorm_analytics(r["rows"], r["d"])["gb"]
        assert abs(gb / (r["xla_fwd_ms"] / 1e3) - r["xla_gb_per_s"]) \
            <= 0.006


def test_overlap_plan_skips_configs_over_the_budget():
    """At 8192 x 512 with the H100's 232,448 bytes a block, the stages
    of (32, 2), (16, 4), (8, 8) and the larger configs do not fit."""
    plan = BK.overlap_plan(False, 232448)
    assert len(plan) == 24
    assert {(c["block_rows"], c["buffer_depth"]) for c in plan
            if "skipped" in c} == {(32, 2), (32, 4), (32, 8), (16, 4),
                                   (16, 8), (8, 8)}
    for c in plan:
        assert c["smem_bytes"] == 2 * c["buffer_depth"] * c["block_rows"] \
            * 512 * 4 + 8 * c["buffer_depth"]
    assert not any("skipped" in c for c in BK.overlap_plan(True, 232448))


def test_cli_cpu_ci_writes_every_reference_section(monkeypatch, tmp_path):
    out = tmp_path / "bench.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.bench.kernels",
                    "--ci", "--device", "cpu", "--out", str(out)],
                   check=True, env=env, cwd=str(tmp_path),
                   capture_output=True, timeout=300)
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["platform"] == "cpu"
    want = _reference_rows(monkeypatch, True)
    for section in SECTIONS:
        keys = BK.CONFIG_KEYS[section]
        assert [tuple(r[k] for k in keys) for r in res[section]] \
            == [tuple(r[k] for k in keys) for r in want[section]]
        for r in res[section]:
            for t in ("kernel_fwd_ms", "kernel_bwd_ms", "plain_fwd_ms",
                      "plain_bwd_ms"):
                assert np.isfinite(r[t]) and r[t] > 0
            # on the CPU both columns are the plain versions
            assert max(r["fwd_err"], *r["grad_err"].values()) <= 2e-5, r
        assert list(res["attention"][0]["grad_err"]) == ["q", "k", "v"]
        assert list(res["rmsnorm"][0]["grad_err_abs_rel"]) == ["scale"]
        assert len(res["ssd"][0]["grad_err"]) == 6
    assert res["overlap"] == {"skipped": "the overlap profile needs the card"}
    assert not (tmp_path / "chiprun_out").exists()


@pytest.mark.parametrize("delta", [-1.01, -0.99, 0.99, 1.01])
@pytest.mark.parametrize("want", [0.0, -3.0, 250.0])
def test_rel_err_is_the_abs_and_rel_tolerance(want, delta):
    """``rel_err(got, want) <= t`` exactly when ``got`` is within t
    absolute and t relative of ``want``: an error just inside or just
    outside t·(1 + |want|) falls on the same side of t."""
    t = 2e-5
    w = torch.tensor([1.0, want], dtype=torch.float64)
    g = w.clone()
    g[1] += delta * t * (1 + abs(want))
    inside = torch.allclose(g, w, atol=t, rtol=t)
    assert inside == (abs(delta) < 1)
    assert (BK.rel_err(g, w) <= t) == inside


def test_rel_err_of_a_sum_is_over_its_terms():
    """With ``terms``, the error is taken over the terms' magnitude."""
    want = torch.tensor([0.5, -2.0])
    got = want + torch.tensor([1e-3, -4e-3])
    terms = torch.tensor([100.0, 400.0])
    assert BK.rel_err(got, want, terms) == pytest.approx(1e-5, rel=1e-3)
    assert BK.rel_err(got, want) == pytest.approx(4e-3 / 3, rel=1e-3)


def test_run_rows_name_the_reference_configs(monkeypatch):
    """``run`` gives the reference's CSV names for the CI sweep."""
    want = _reference_rows(monkeypatch, True)
    names = [f"kernels/{s}/" + "x".join(str(v) for v in r.values()
                                        if isinstance(v, int))
             for s in SECTIONS for r in want[s]]
    rows = BK.run(device="cpu")
    assert [r[0] for r in rows] == names
    assert all(r[1] > 0 and r[2].startswith("bwd_ms=") for r in rows)


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        BK.main(["--ci", "--out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()


def test_overlap_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        OV.overlap_norm(torch.zeros(64, 64), block_rows=16, depth=2)
