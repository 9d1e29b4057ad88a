"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), their
wrappers and their plain PyTorch versions; ``kernels.backend`` is the
entry the models call."""
