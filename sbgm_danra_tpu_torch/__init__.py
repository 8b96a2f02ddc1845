"""PyTorch + CUDA port of ``sbgm_danra_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference. Module names mirror it, public
functions keep its NHWC layout, and each module holds the same numerics (the
``tests/test_torch_*.py`` files compare the two on the CPU). The Pallas flash
attention kernel is replaced by a hand-written CUDA kernel
(``csrc/flash_attention.cu``, bound in ``ops/cuda_attention.py``). This package
imports no JAX.
"""
