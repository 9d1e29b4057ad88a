"""Not a test (pytest does not collect it): phase 4's training plan on
the CPU through the JAX package's ``Trainer`` and the port's, on the
same weights, to tell a schedule's loss spike from a port fault.

seesaw-150m at full width cut to 2 layers, Seesaw α=2 with two cuts,
base LR 3e-3 after a 3-step warmup, B = 8 / 16 / 32 of 1024 tokens over
24·8·1024 tokens, AdamW 0.9/0.95 with clip 1.0, bfloat16 compute,
``MarkovLM(2048, seed 0)``, ``fuse_steps=4``, ``max_device_batch=8``.
Prints one line per step: framework, step, batch size, LR, loss, grad
norm.  About ten minutes per framework on four CPU threads:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/loss_spike_jax_vs_port.py [jax|port]
"""
import dataclasses
import sys

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


def run_config(Run, Sch, Opt, cfg):
    return Run(model=dataclasses.replace(cfg, n_layers=2),
               schedule=Sch(kind="seesaw", alpha=2.0, n_cuts=2),
               optimizer=Opt(kind="adamw", beta1=0.9, beta2=0.95,
                             grad_clip=1.0),
               seq_len=1024, global_batch_size=8,
               total_tokens=24 * 8 * 1024, dtype="bfloat16")


def main(which):
    jcfg = run_config(JRunConfig, JScheduleConfig, JOptimizerConfig,
                      j_get_config("seesaw-150m"))
    jtr = JTrainer(jcfg, fuse_steps=4, max_device_batch=8)
    if which == "jax":
        jtr.run(JLoader(JMarkovLM(2048, seed=0), jtr.plan, 1024))
        hist = jtr.history
    else:
        tr = Trainer(run_config(RunConfig, ScheduleConfig, OptimizerConfig,
                                get_config("seesaw-150m")),
                     device="cpu", fuse_steps=4, max_device_batch=8)
        model = from_jax_params(jax.tree.map(np.asarray, jtr.state.params),
                                tr.cfg.model, dtype=torch.float32,
                                device="cpu")
        tr.state.model.load_state_dict(model.state_dict())
        tr.run(PhaseDataLoader(MarkovLM(2048, seed=0), tr.plan, 1024,
                               device="cpu"))
        hist = tr.history
    for h in hist:
        print(which, h["step"], h["batch_size"], f"{h['lr']:.6g}",
              f"{h['loss']:.6g}", f"{h['grad_norm']:.6g}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "port")
