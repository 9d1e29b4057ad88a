"""The PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It imports nothing of the JAX package, which stays beside it as the
reference the tests hold it against.  Every Pallas kernel on a ported
path is a CUDA kernel written by hand for Hopper (``csrc/``), built with
nvcc at first use.  Entry points run on ``device="cuda"`` unless the
caller asks for ``"cpu"``, where the kernels' plain PyTorch versions
run; nothing moves to the CPU on its own.

Ported so far: serving the dense family (``serving.ServingEngine``).
"""
