"""Custom ops: the CUDA flash-attention kernel and its dispatcher, the stem conv, 2x upsampling."""
