"""Two chip runs' plans on the CPU, the port against the JAX package on
the same weights: chip_smoke's phase 14b (granite-moe-1b-a400m, Seesaw
α = 2 with one cut, B = 8 then 16) and phase 15b (recurrentgemma-9b, B =
4 then 8), both at base LR 3e-3 with AdamW 0.9/0.95 and clip 1.0, at the
reduced configs (the hybrid cut to 5 layers) with the data's vocabulary
of 2048, 128 tokens a sequence, float32.

Step for step: the batch, phase and LR equal, the loss within 5e-4, the
grad norm within 1e-3 of the reference's, and for the MoE ``lb_loss``,
``rz_loss`` and ``frac_dropped`` within 5e-3.  The same plans at the
published widths in bfloat16 (where the router's drops climb and the
loss turns up in both packages) are ``tests/plan_runs_jax_vs_port.py``.
"""
import pytest
import torch

from plan_runs_jax_vs_port import MOE_KEYS, histories


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("plan,n_steps", [("granite", 9), ("hybrid", 8)])
def test_plan_matches_jax_step_for_step(plan, n_steps):
    port, ref = histories(plan, "reduced", seq=128, dtype="float32")
    assert len(port) == len(ref) == n_steps
    assert len({h["batch_size"] for h in port}) == 2
    for a, b in zip(port, ref):
        assert (a["step"], a["tokens"], a["batch_size"], a["phase"]) == \
            (b["step"], b["tokens"], b["batch_size"], b["phase"])
        assert float(a["lr"]) == pytest.approx(float(b["lr"]), rel=1e-6)
        assert abs(a["loss"] - b["loss"]) < 5e-4, a["step"]
        assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-3 * b["grad_norm"]
        for k in MOE_KEYS:
            if plan == "granite":
                assert abs(a[k] - b[k]) < 5e-3, (a["step"], k)
            else:
                assert k not in a
