"""PyTorch + CUDA port of ``sbgm_danra_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference. Module names mirror it, public
functions keep its NHWC layout, and each module holds the same numerics (the
``tests/test_torch_*.py`` files compare the two on the CPU). Each Pallas kernel
is replaced by a hand-written CUDA kernel: flash attention
(``csrc/flash_attention.cu``, bound in ``ops/cuda_attention.py``) and the fused
conv3x3 + GroupNorm of the decoder (``csrc/conv3x3_gn.cu``, bound in
``ops/fused_conv_gn.py``). This package imports no JAX and nothing of the JAX
package.
"""
