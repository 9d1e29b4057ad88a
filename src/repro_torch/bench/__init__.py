"""Benchmarks of the port: ``kernels`` (per-kernel sweeps and the
copy/compute-overlap profile) and ``timing`` (the card's timer and
bounds, shared with ``chip_smoke.py``)."""
