"""Not a test (pytest does not collect it): the training plans of
chip_smoke's phases 14b (granite-moe-1b-a400m) and 15b
(recurrentgemma-9b) on the CPU through the JAX package's ``Trainer`` and
the port's, on the same weights, to tell a run's own behaviour (the MoE
router's drops, the hybrid's late loss) from a port fault.

Both plans: Seesaw α = 2 with one cut, base LR 3e-3 after the 10%
warmup, AdamW 0.9/0.95 with clip 1.0, ``MarkovLM(2048, seed 0)``,
``fuse_steps=4``; granite B = 8 then 16 over 10·8 sequences, the hybrid
B = 4 then 8 over 9·4 sequences, both at ``--seq`` tokens (default 256).
``--width reduced`` is the config's ``reduced()`` (the hybrid cut to 5
layers); ``--width wide`` keeps the published widths (d, heads,
experts, the LRU width) cut to 2 layers (for the hybrid two recurrent
layers, 0.47B parameters: run it at `--seq 128`).
Both take a vocabulary of 2048, the data's.  Prints one line per step:
step, batch size, LR, then port/JAX pairs of the loss, the grad norm and,
for the MoE, ``lb_loss``, ``rz_loss`` and ``frac_dropped``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/plan_runs_jax_vs_port.py \
        granite|hybrid [--width reduced|wide] [--dtype float32|bfloat16]

The reduced float32 runs are ``tests/test_torch_plan_runs.py``.
"""
import argparse
import dataclasses
import time

import jax
import numpy as np
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ScheduleConfig as JScheduleConfig
from repro.configs import get_config as j_get_config
from repro.data import MarkovLM as JMarkovLM
from repro.data import PhaseDataLoader as JLoader
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import (OptimizerConfig, RunConfig, ScheduleConfig,
                                 get_config)
from repro_torch.data import MarkovLM, PhaseDataLoader
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params

# arch, B0, sequences in the plan, layers of the reduced / wide cut
PLANS = {"granite": ("granite-moe-1b-a400m", 8, 10 * 8, None, 2),
         "hybrid": ("recurrentgemma-9b", 4, 9 * 4, 5, 2)}
MOE_KEYS = ("lb_loss", "rz_loss", "frac_dropped")


def run_config(ours: bool, plan: str, width: str, seq: int, dtype: str):
    get, Sch, Opt, Run = ((get_config, ScheduleConfig, OptimizerConfig,
                           RunConfig) if ours else
                          (j_get_config, JScheduleConfig, JOptimizerConfig,
                           JRunConfig))
    arch, b0, n_seq, reduced_layers, wide_layers = PLANS[plan]
    model = get(arch)
    if width == "reduced":
        model = model.reduced()
        layers = reduced_layers or model.n_layers
    else:
        layers = wide_layers
    model = dataclasses.replace(model, n_layers=layers, vocab_size=2048)
    return Run(model=model,
               schedule=Sch(kind="seesaw", alpha=2.0, n_cuts=1),
               optimizer=Opt(kind="adamw", beta1=0.9, beta2=0.95,
                             grad_clip=1.0),
               seq_len=seq, global_batch_size=b0,
               total_tokens=n_seq * seq, dtype=dtype)


def histories(plan: str, width: str = "reduced", seq: int = 256,
              dtype: str = "float32"):
    """(port history, JAX history) of the plan on the same weights."""
    b0 = PLANS[plan][1]
    jtr = JTrainer(run_config(False, plan, width, seq, dtype), fuse_steps=4,
                   max_device_batch=b0)
    tr = Trainer(run_config(True, plan, width, seq, dtype), device="cpu",
                 fuse_steps=4, max_device_batch=b0)
    model = from_jax_params(jax.tree.map(np.asarray, jtr.state.params),
                            tr.cfg.model, dtype=torch.float32, device="cpu")
    tr.state.model.load_state_dict(model.state_dict())
    jtr.run(JLoader(JMarkovLM(2048, seed=0), jtr.plan, seq))
    tr.run(PhaseDataLoader(MarkovLM(2048, seed=0), tr.plan, seq,
                           device="cpu"))
    return tr.history, jtr.history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("plan", choices=sorted(PLANS))
    ap.add_argument("--width", default="reduced", choices=("reduced", "wide"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    t0 = time.perf_counter()
    port, ref = histories(args.plan, args.width, args.seq, args.dtype)
    for a, b in zip(port, ref):
        extra = [f"{k} {a[k]:.5f} {b[k]:.5f}" for k in MOE_KEYS if k in a]
        print(args.plan, args.width, args.dtype, a["step"], a["batch_size"],
              f"lr {a['lr']:.6g}", f"loss {a['loss']:.6f} {b['loss']:.6f}",
              f"gnorm {a['grad_norm']:.5f} {b['grad_norm']:.5f}", *extra,
              flush=True)
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
