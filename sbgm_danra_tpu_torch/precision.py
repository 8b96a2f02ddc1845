"""One precision rule for float32 models on the card.

PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. The port's fp32 kernels pay for 3xTF32 to keep fp32's
accuracy, and its contract is parity with the JAX package's fp32, so the
entry points that run a float32 model (full-domain sampling, the serving
engine's dispatches, the trainer's steps) run their calls inside
``exact_fp32``, which turns TF32 off for cuDNN and cuBLAS and puts the flags
back as they were when the call returns. Nothing outside such a call, and
no bf16 model, sees a changed flag. The flags are process-wide, so a bf16
call that runs on another thread during an fp32 call runs without TF32.
"""

from __future__ import annotations

import contextlib
import logging

import torch

logger = logging.getLogger(__name__)
_logged = False


@contextlib.contextmanager
def exact_fp32(compute_dtype):
    """For a float32 ``compute_dtype`` (a name or a torch dtype), set
    ``cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32`` to False inside the
    block and restore both after it (logged once); for any other dtype,
    change nothing. Also a decorator: ``exact_fp32(dtype)(fn)``."""
    if compute_dtype not in ("float32", torch.float32):
        yield
        return
    global _logged
    if not _logged:
        logger.info("float32 model: TF32 off for cuDNN convolutions and cuBLAS matmuls "
                    "inside its calls")
        _logged = True
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
