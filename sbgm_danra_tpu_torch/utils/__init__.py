"""Numpy-only helpers of the data path (copies of ``sbgm_danra_tpu/utils``, cut to what the port reads)."""
