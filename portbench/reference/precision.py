"""The precisions the plain references compute in.

``float32`` is float32 with TF32 off: the reference.  The controls are the
reference one precision lower than the configuration states: ``tf32`` for
a float32 cell (on CUDA the library's own TF32, turned on for the block;
on the CPU each conv's operands rounded to TF32's 10 mantissa bits) and
``fp8`` for a bfloat16 cell (each conv's operands scaled per tensor into
float8 e4m3's range, rounded to it, and scaled back).
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).view(t.shape)


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` scaled by its largest magnitude into e4m3's range, rounded to
    float8 e4m3fn, scaled back to float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """``rnd(t)`` rounds a conv operand; ``scope()`` sets the library's float32 flags for the block
    and restores them after it."""

    def __init__(self, name: str, device):
        if name not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.device = torch.device(device)
        self.native_tf32 = name == "tf32" and self.device.type == "cuda"

    def rnd(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or self.native_tf32:
            return t
        return _round_fp8(t) if self.name == "fp8" else _round_tf32(t)

    @contextlib.contextmanager
    def scope(self):
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.native_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.native_tf32
        try:
            yield self
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
