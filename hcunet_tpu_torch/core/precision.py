"""float32 computed in float32.

torch lets cuDNN's convolutions (and cuBLAS's matmuls, on some versions)
run float32 inputs through TF32, whose products keep 10 mantissa bits.  The
JAX package computes float32 in float32, and on the card TF32 moved a
float32 ``analyze``'s map by 8.2e-5 and its cells from 3 to 7, and a
RecursiveUNet's second training loss by 4.0 % (fault F4, ``PERF.md``).
The library's entry points therefore run their float32 work inside
:func:`exact_float32`, which turns TF32 off for the block and gives the
caller's settings back after it: a library does not change a process's
global settings.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """Turn ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` off for the block and restore
    the caller's values on exit.  Also a decorator (``@exact_float32()``).
    The flags are process-wide: the block sets them for every thread, and
    nested blocks restore in order."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
