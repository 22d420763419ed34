"""Blocked matrix product, kernel K3 (``csrc/dot_blocked.cu``).

The port of the TPU control ``scripts/probe_pallas_dot.py::pallas_dot``:
``[B, X, Y, K] @ [K, N]`` with float32 accumulation and the output in
``x``'s dtype.  It runs on no path of the system; ``chip_smoke.py`` launches
it beside K1 at the TPU probe's shapes and at the GEMM shape of each of
K1's layers, to split K1's shortfall into the product itself and the tap
gather.  The Pallas row-block argument ``tx`` has no counterpart: the CUDA
kernel tiles rows itself.

K3 has two paths (:func:`dot_blocked_route`): a TMA ring feeding wgmma
for bfloat16 with ``K % 8 == 0`` and ``N % 8 == 0``, and a basic one for
the rest (float32: a ``cp.async`` ring feeding FMA register tiles, exact
float32 with no TF32; bfloat16: WMMA).  :func:`dot_blocked` launches K3
for a CUDA tensor and raises if it cannot; only a tensor on the CPU takes
:func:`dot_blocked_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from hcunet_tpu_torch.csrc import CudaKernel, aligned16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# K3's two paths, by the number its C entry point dot_blocked_route gives:
# the C entry point decides, and dot_blocked_route below names the same
# choice (a CUDA test holds the two to each other)
DOT_ROUTES = ("basic", "ring")

DOT_BLOCKED = CudaKernel(
    "dot_blocked.cu", "dot_blocked", [_I, _P, _P, _P, _L, _I, _I, _P], routes=DOT_ROUTES
)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dot_blocked_route(dtype: torch.dtype, k: int, n: int) -> str:
    """The path K3 takes for a call, a function of (dtype, K, N) alone:
    ``"ring"`` (the TMA ring feeding wgmma) for bfloat16 with
    ``K % 8 == 0`` and ``N % 8 == 0`` (rows of whole 16-byte chunks), else
    ``"basic"``.  The same rule as the C entry point ``dot_blocked_route``
    in ``csrc/dot_blocked.cu``, which decides."""
    return "ring" if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 else "basic"


def dot_blocked_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: the product in float32, cast back to
    ``x``'s dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def dot_blocked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, X, Y, K]`` @ ``w`` ``[K, N]`` → ``[B, X, Y, N]`` in ``x``'s
    dtype, summed in float32.

    Both on one device: a CUDA tensor launches K3 (float32 or bfloat16, the
    same for both, contiguous) on the path :func:`dot_blocked_route` names,
    a CPU tensor runs :func:`dot_blocked_plain`.  Any other device, mixed
    devices, or an input K3 does not take, raises.  The ring path copies 16
    bytes at a time, so there an ``x`` or ``w`` that does not start on a
    16-byte boundary is first copied once into a fresh, aligned allocation.
    """
    if w.device != x.device:
        raise ValueError(f"dot_blocked: x on {x.device}, w on {w.device}")
    if x.ndim != 4 or w.ndim != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(
            f"dot_blocked: x [B,X,Y,K] and w [K,N] expected, got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.device.type == "cpu":
        return dot_blocked_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dot_blocked: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"dot_blocked takes float32 or bfloat16 x and w of one dtype, "
            f"got {x.dtype} and {w.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dot_blocked: x and w must be contiguous")
    K, N = w.shape
    y = torch.empty((*x.shape[:-1], N), device=x.device, dtype=x.dtype)
    M = y.numel() // N if N else 0
    if M == 0 or N == 0:
        return y
    route = dot_blocked_route(x.dtype, K, N)
    if route == "ring":
        x, w = aligned16(x), aligned16(w)
    fn = DOT_BLOCKED.function()
    with torch.cuda.device(x.device):
        rc = fn(
            _KERNEL_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dot_blocked kernel launch failed: CUDA error {rc}")
    DOT_BLOCKED.launches += 1
    DOT_BLOCKED.route_launches[route] += 1
    return y
