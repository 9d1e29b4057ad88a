"""Benchmarks of the port: the paper's tables and figures (``run``, the
harness of ``figure1`` … ``figure6_zloss``, ``table1`` and ``lemma1``),
``kernels`` (per-kernel sweeps and the copy/compute-overlap profile),
``variants`` (one-change kernel variants) and ``timing`` (the card's
timer and bounds, shared with ``chip_smoke.py``)."""
