"""The port's serving, engine and checkpoint benchmarks and the
``serve_decode`` example, on the CPU, at small step and request counts.

The rows must be the reference's (``benchmarks/bench_serve.py``,
``bench_engine.py``, ``bench_checkpoint.py``) in its order, and each
benchmark's own gates must pass: ``check_compiles`` (one step-cache
entry per distinct batch size; at most one prefill entry per prompt
bucket and one decode entry), ``check_schema`` (the checkpoint's
on-disk contract and a bitwise restore).  ``check_stall`` is a timing
gate, held on the card (chip_smoke's phase 14d); here it is checked to
flag a slow async save.  The suites are registered in the harness in
``benchmarks/run.py``'s order.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.bench import checkpoint as BC
from repro_torch.bench import engine as BE
from repro_torch.bench import run as bench_run
from repro_torch.bench import serve as BS
from repro_torch.examples import serve_decode

# the reference's row names, in its order
ENGINE_ROWS = [f"engine/{r}/{n}" for r in ("dispatch", "smoke150m")
               for n in ("eager_per_step_sync", "fused_k1", "fused_k4",
                         "fused_k16", "host_overhead_us_per_step")] + \
    ["engine/compiles/seesaw", "engine/compiles/step"]
SERVE_ROWS = ["serve/throughput/speedup", "serve/rate0.5/request",
              "serve/rate2.0/request", "serve/compiles"]
CHECKPOINT_ROWS = ["checkpoint/stall_sync", "checkpoint/stall_async"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the benchmarks' small models run many small
    ops, which the thread pools of several test workers on a shared CPU
    slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_harness_registers_engine_and_serve():
    assert list(bench_run.SUITES)[-2:] == ["engine", "serve"]
    assert bench_run.SUITES["engine"] == ("engine", True)
    assert bench_run.SUITES["serve"] == ("serve", True)


@pytest.fixture(scope="module")
def engine_run():
    return BE._measure(48, schedule="adaptive-seesaw", device="cpu")


def test_engine_rows_and_compiles(engine_run):
    rows, result = engine_run
    assert [r[0] for r in rows] == ENGINE_ROWS + ["engine/compiles/adaptive"]
    for name, us, _ in rows[:10]:
        # the host's overhead is a difference of two times: any sign
        assert np.isfinite(us) and (us > 0 or "overhead" in name), name
    assert BE.check_compiles(result) == []
    c = result["compiles"]
    assert (c["seesaw"]["executables"], c["step"]["executables"]) == (3, 1)
    assert c["seesaw"]["chunk_ks"] == [16]
    assert c["adaptive"]["cuts"] >= 1
    # a second entry for one batch size is caught
    c["step"]["executables"] = 2
    assert BE.check_compiles(result)
    c["step"]["executables"] = 1


def test_engine_suite_through_the_harness(engine_run, capsys, monkeypatch):
    """``python -m repro_torch.bench.run --only engine --device cpu``
    prints the suite's rows as the reference's CSV (the rows of the
    48-step run above: ``run`` is ``_measure``'s rows)."""
    rows = [r for r in engine_run[0] if r[0] != "engine/compiles/adaptive"]
    monkeypatch.setattr(BE, "run", lambda device: rows)
    assert bench_run.main(["--only", "engine", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == ENGINE_ROWS


def test_serve_rows_and_compiles(capsys, tmp_path):
    """``bench.serve`` at 4 requests a workload through its CLI: the
    reference's rows, the compile gate, the JSON record."""
    out_json = tmp_path / "bench_serve.json"
    assert BS.main(["--requests", "4", "--device", "cpu",
                    "--check-compiles", "--out", str(out_json)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:5]] == SERVE_ROWS
    assert "serving compile invariant OK" in out[-1]
    assert json.loads(out_json.read_text())["compiles"]["budget"] == 5


def test_serve_measure_and_gate():
    rows, result = BS._measure(n_requests=3, device="cpu")
    assert [r[0] for r in rows] == SERVE_ROWS
    c = result["compiles"]
    assert c["decode_executables"] == 1
    assert c["prefill_executables"] <= c["prompt_buckets"] == 4
    assert BS.check_compiles(result) == []
    assert result["throughput"]["static"]["max_len"] == \
        BS.MAX_LEN + BS.LONG_BUDGET
    for rec in result["rates"].values():
        assert rec["n_requests"] == 3 and rec["generated_tokens"] > 0
    c["decode_executables"] = 2
    assert BS.check_compiles(result)


def test_serve_trace_is_the_reference_mix():
    """The seeded Poisson trace: budgets of 4-10 or 40-64, prompts that
    leave room for them within MAX_LEN, arrivals increasing."""
    trace = BS._trace(64, 2.0, seed=0)
    t = [a for a, _ in trace]
    assert t == sorted(t)
    for _, r in trace:
        n = r.max_new_tokens
        assert 4 <= n <= 10 or 40 <= n <= 64
        assert 2 <= len(r.prompt) < BS.MAX_LEN - n
    assert {r.max_new_tokens >= 40 for _, r in trace} == {True, False}


def test_checkpoint_rows_and_gates():
    rows, result = BC._measure(2, device="cpu")
    assert [r[0] for r in rows] == CHECKPOINT_ROWS
    assert result["state_bytes"] > 1e6
    assert result["stall_sync_s"] > 0 and result["stall_async_s"] > 0
    slow = dict(result, ratio=2.0)
    assert BC.check_stall(slow)
    assert BC.check_stall(dict(result, ratio=6.0)) == []
    assert BC.check_schema("cpu") == []


def test_checkpoint_schema_catches_a_bad_block(monkeypatch):
    """A crc mismatch on disk is an error of the schema gate."""
    from repro_torch.train import checkpoint as C
    monkeypatch.setattr(C, "_crc_of_file", lambda path: -1)
    errors = BC.check_schema("cpu")
    assert errors and all("crc mismatch" in e for e in errors[:-1])
    assert errors[-1].startswith("restore: checksum mismatch")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "starcoder2-3b",
                                  "recurrentgemma-9b"])
def test_serve_decode_example(arch, capsys):
    """The engine where ``serving_mode`` allows it (granite: paged), the
    blocking ``Server`` for a sliding window and for the RG-LRU hybrid
    (its rings and recurrent states)."""
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--new-tokens", "4"]
    out = serve_decode.main(argv)
    text = capsys.readouterr().out
    if arch in ("starcoder2-3b", "recurrentgemma-9b"):
        assert "blocking Server" in text and out.shape == (2, 4)
    else:
        assert "serving_mode=paged" in text and out.done
        assert all(len(r.tokens) >= 2 for r in out._results.values())
