"""The paper's benchmarks on the port — one module per table or figure
(``benchmarks/run.py``'s harness and CSV).

    python -m repro_torch.bench.run [--only figure1] [--device cpu]

Prints ``name,us_per_call,derived`` CSV, the reference's rows in the
reference's order.  The theory suites (Table 1, Figures 2, 3 and 5,
Lemma 1) are exact host recursions in numpy; Figures 1, 4 and 6 train
their LMs through ``Trainer`` on ``--device`` (the card by default,
where the LMs run the hand-written kernels at head_dim 32); ``engine``
(``bench/engine.py``) trains and ``serve`` (``bench/serve.py``) serves
the reference's reduced LMs there.  A suite that raises prints an
``ERROR`` row, and the run exits with code 1.  The checkpoint benchmark
is not a suite of the reference's harness either: run it as
``python -m repro_torch.bench.checkpoint``.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Tuple

# the reference's suites, in its order: name -> (module, trains on device)
SUITES = {
    "figure1": ("figure1", True),
    "table1": ("table1", False),
    "figure2": ("figure2", False),
    "figure3": ("figure3", False),
    "figure4": ("figure4_wd", True),
    "figure5": ("figure5", False),
    "figure6": ("figure6_zloss", True),
    "lemma1": ("lemma1", False),
    "engine": ("engine", True),
    "serve": ("serve", True),
}


def suite_rows(name: str, device: str) -> List[Tuple[str, float, str]]:
    """The rows of one suite."""
    if name not in SUITES:
        raise KeyError(f"unknown suite {name!r}; known: {list(SUITES)}")
    module, trains = SUITES[name]
    mod = importlib.import_module(f"repro_torch.bench.{module}")
    return mod.run(device=device) if trains else mod.run()


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the LM suites train (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.only is not None and args.only not in SUITES:
        suite_rows(args.only, args.device)       # raises, naming why
    print("name,us_per_call,derived")
    failures = 0
    for name in SUITES:
        if args.only and args.only != name:
            continue
        try:
            for row in suite_rows(name, args.device):
                print(csv_row(*row))
        except Exception as e:           # noqa: BLE001 — an ERROR row
            failures += 1
            print(f"{name}/ERROR,0,{type(e).__name__}:{e}")
        sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
