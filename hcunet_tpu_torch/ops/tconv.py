"""The transposed conv of stride (2, 2, 1) with an even x/y kernel in its
subpixel form: the U-Net's upsampling, channels-last.

Output x ``2m + rx``, y ``2n + ry`` of the transposed conv is parity
``(rx, ry)`` of one valid conv of the zero-padded input
(:func:`subpixel_pads`) with the four parity kernels stacked along Cout
(:func:`subpixel_tconv_weights`).  Two routes compute it:

* :func:`tconv3d_subpixel`, float32 straight into a caller's buffer, the
  input of the up level's first conv, whose other channels the caller fills
  with the skip: on a CUDA tensor through ``csrc/tconv3d_subpixel.cu``
  (launches counted in ``TCONV3D_SUBPIXEL``), on a CPU tensor through
  :func:`tconv3d_subpixel_plain` (``F.conv_transpose3d``);
* :func:`tconv_subpixel`, any dtype and any padding :func:`subpixel_pads`
  takes: the padded input, one valid conv (kernel K1 by default) and an
  interleave.

The JAX package has no Pallas kernel for this: XLA runs its
``tconv_packed_subpixel``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from hcunet_tpu_torch.csrc import CudaKernel
from hcunet_tpu_torch.ops.conv import conv3d_valid, conv_transpose_torch

_P, _I = ctypes.c_void_p, ctypes.c_int

TCONV3D_SUBPIXEL = CudaKernel(
    "tconv3d_subpixel.cu",
    "tconv3d_subpixel",
    [_P] * 4 + [_I] * 16 + [_P],
)


def subpixel_pads(kernel: Sequence[int], pad: Sequence[int] | int = 0):
    """The input padding ``(px, py, pz)`` of the stacked parity conv that
    computes a transposed conv of stride (2, 2, 1), kernel ``kernel`` and
    torch padding ``pad``, or None where that route does not apply.

    Parity ``r`` of output x ``2m + r`` sums ``x[m + o] w[t]`` over the taps
    ``t = r + pad (mod 2)``, ``o = (r + pad - t) / 2``: for an even kernel
    ``k`` and an even ``pad <= k - 2`` both parities take ``k / 2`` taps at
    the offsets ``-(k/2 - 1 - pad/2) .. pad/2``, so one valid conv of the
    input zero-padded by ``k/2 - 1 - pad/2`` on both sides gives every
    output of both (the JAX package's ``_subpixel_taps`` rule, which also
    asks the two sides to be equal; at ``pad = k/2 - 1`` they are, and its
    taps are these).  z (stride 1) is the transposed conv's own valid conv
    with the kernel flipped, padded by ``kz - 1 - pad``."""
    kx, ky, kz = (int(k) for k in kernel)
    px, py, pz = (pad,) * 3 if isinstance(pad, int) else (int(p) for p in pad)
    for k, p in ((kx, px), (ky, py)):
        if k % 2 or p % 2 or p > k - 2:
            return None
    if pz > kz - 1:
        return None
    return kx // 2 - 1 - px // 2, ky // 2 - 1 - py // 2, kz - 1 - pz


def subpixel_tconv_weights(w_up: torch.Tensor) -> torch.Tensor:
    """The four parity kernels of a stride-(2, 2, 1) transposed conv with
    an even x/y kernel, stacked along Cout.

    ``w_up`` ``[kx, ky, kz, Cin, Cout]`` (the transposed conv's weight,
    channels-last) gives ``[kx/2, ky/2, kz, Cin, 4 * Cout]`` with
    ``w[ux, uy, uz, :, (2 rx + ry) * Cout + c] = w_up[kx-2-2ux+rx,
    ky-2-2uy+ry, kz-1-uz, :, c]``: the JAX package's
    ``pack_tconv_subpixel_weights`` (x/y parity taps, flipped, and z
    flipped), with the parities side by side.  The taps do not depend on
    the transposed conv's padding (:func:`subpixel_pads`)."""
    kx, ky = w_up.shape[0], w_up.shape[1]
    ux = torch.arange(kx // 2)
    uy = torch.arange(ky // 2)
    subs = [
        w_up[kx - 2 - 2 * ux + rx][:, ky - 2 - 2 * uy + ry].flip(2)
        for rx in (0, 1)
        for ry in (0, 1)
    ]
    return torch.cat(subs, dim=-1).contiguous()


def tconv_subpixel(
    x: torch.Tensor,
    w_sub: torch.Tensor,
    b_sub: torch.Tensor,
    conv: Callable = conv3d_valid,
    pad: Sequence[int] | int = 0,
) -> torch.Tensor:
    """A stride-(2, 2, 1) transposed conv with torch padding ``pad`` as one
    valid conv and an interleave: ``x`` ``[B, X, Y, Z, Cin]`` zero-padded by
    :func:`subpixel_pads` (one allocation), ``conv`` with the stacked parity
    kernels ``w_sub`` (:func:`subpixel_tconv_weights`) and the bias
    repeated per parity ``b_sub`` (float32 ``[4 * Cout]``), then
    ``out[2m + rx, 2n + ry] = parity (rx, ry)[m, n]``.  Returns
    ``[B, 2X + kx - 2 - 2 pad, 2Y + ky - 2 - 2 pad, Z + kz - 1 - 2 pad,
    Cout]`` in ``x``'s dtype, the transposed conv's output with its bias.
    ``pad`` must be one that :func:`subpixel_pads` takes."""
    hx, hy, kz = w_sub.shape[:3]
    px, py, pz = subpixel_pads((2 * hx, 2 * hy, kz), pad)
    y = conv(F.pad(x, (0, 0, pz, pz, py, py, px, px)).contiguous(), w_sub, b_sub, False)
    B, Xo, Yo, Zo, n = y.shape
    y = y.reshape(B, Xo, Yo, Zo, 2, 2, n // 4).permute(0, 1, 4, 2, 5, 3, 6)
    return y.reshape(B, 2 * Xo, 2 * Yo, Zo, n // 4)


def transposed_conv_weights(w_sub: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`subpixel_tconv_weights`: the transposed conv's
    ``[kx, ky, kz, Cin, Cout]`` weight, contiguous, its values moved and
    never rounded."""
    hx, hy, kz, cin, n = w_sub.shape
    cout = n // 4
    # [ux, uy, uz, Cin, rx, ry, c] -> [ux, rx, uy, ry, uz, Cin, c]
    w = w_sub.reshape(hx, hy, kz, cin, 2, 2, cout).permute(0, 4, 1, 5, 2, 3, 6)
    # x index kx-2-2ux+rx runs down as ux rises and up with rx: flip ux alone
    w = w.flip(0, 2, 4).reshape(2 * hx, 2 * hy, kz, cin, cout)
    return w.contiguous()


def tconv3d_subpixel_extent(x_shape: Sequence[int], w_sub_shape: Sequence[int]) -> tuple:
    """The spatial extent ``(2X + kx - 2, 2Y + ky - 2, Z + kz - 1)`` of the
    unpadded transposed conv whose input is ``x_shape`` ``[B, X, Y, Z, Cin]``
    and whose stacked parity kernels are ``w_sub_shape``."""
    hx, hy, kz = (int(k) for k in w_sub_shape[:3])
    X, Y, Z = (int(s) for s in x_shape[1:4])
    return 2 * (X + hx - 1), 2 * (Y + hy - 1), Z + kz - 1


def tconv3d_subpixel_takes(cin: int, cout: int) -> bool:
    """Whether the kernel takes these widths: 16-byte copies of 4 input
    channels and 16-byte stores of 4 output channels."""
    return cin % 4 == 0 and cout % 4 == 0


def tconv3d_subpixel_plain(
    x: torch.Tensor, w_sub: torch.Tensor, b_sub: torch.Tensor, out: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tconv3d_subpixel`: the transposed
    conv in float32 (``conv_transpose_torch`` with the weight unstacked and
    the bias), its top-left crop to ``out``'s extent written into channels
    ``0 .. Cout - 1`` of ``out``."""
    cout = w_sub.shape[-1] // 4
    y = conv_transpose_torch(
        x, transposed_conv_weights(w_sub), b_sub[:cout], stride=(2, 2, 1),
        accum_dtype=torch.float32,
    )
    cx, cy, cz = out.shape[1:4]
    out[..., :cout] = y[:, :cx, :cy, :cz]
    return out


def tconv3d_subpixel(
    x: torch.Tensor, w_sub: torch.Tensor, b_sub: torch.Tensor, out: torch.Tensor
) -> torch.Tensor:
    """The transposed conv of stride (2, 2, 1), no padding, whose stacked
    parity kernels are ``w_sub`` (:func:`subpixel_tconv_weights`), into
    channels ``0 .. Cout - 1`` of ``out``; returns ``out``.

    ``x`` ``[B, X, Y, Z, Cin]``, ``w_sub`` ``[kx/2, ky/2, kz, Cin, 4 Cout]``
    and ``b_sub`` (the bias repeated per parity, ``[4 Cout]``) in float32;
    ``out`` ``[B, CX, CY, CZ, C]`` float32 with ``C >= Cout`` and an extent
    at most the transposed conv's (:func:`tconv3d_subpixel_extent`): it
    receives the top-left crop.  Channels ``Cout ..`` of ``out`` are not
    touched.

    A CUDA tensor launches ``csrc/tconv3d_subpixel.cu`` (exact float32 on
    the FMA units, the padding inside the kernel); a CPU tensor runs
    :func:`tconv3d_subpixel_plain`.  Any other device, another dtype, a
    tensor that is not contiguous or not 16-byte aligned, widths that
    :func:`tconv3d_subpixel_takes` refuses or an ``out`` larger than the
    transposed conv raise."""
    if x.device.type == "cpu":
        return tconv3d_subpixel_plain(x, w_sub, b_sub, out)
    if x.device.type != "cuda":
        raise ValueError(f"tconv3d_subpixel: no kernel for device {x.device}")
    tensors = (("x", x), ("w_sub", w_sub), ("b_sub", b_sub), ("out", out))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"tconv3d_subpixel takes float32 only, {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tconv3d_subpixel: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"tconv3d_subpixel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"tconv3d_subpixel: {name} must start on a 16-byte boundary")
    if x.ndim != 5 or w_sub.ndim != 5 or out.ndim != 5 or w_sub.shape[3] != x.shape[4]:
        raise ValueError(
            f"tconv3d_subpixel: x [B,X,Y,Z,Cin], w_sub [hx,hy,kz,Cin,4Cout] and out "
            f"[B,CX,CY,CZ,C] expected, got {tuple(x.shape)}, {tuple(w_sub.shape)} and "
            f"{tuple(out.shape)}"
        )
    B, X, Y, Z, cin = x.shape
    hx, hy, kz, _, n = w_sub.shape
    cout = n // 4
    extent = tconv3d_subpixel_extent(x.shape, w_sub.shape)
    if (n % 4 or not tconv3d_subpixel_takes(cin, cout) or b_sub.shape != (n,)
            or out.shape[0] != B or out.shape[4] < cout or out.shape[4] % 4
            or any(c > e for c, e in zip(out.shape[1:4], extent))):
        raise ValueError(
            f"tconv3d_subpixel: no kernel for x {tuple(x.shape)}, w_sub {tuple(w_sub.shape)}, "
            f"b_sub {tuple(b_sub.shape)} into out {tuple(out.shape)} (transposed conv "
            f"extent {extent}; Cin and Cout multiples of 4)"
        )
    if out.numel() == 0:
        return out
    px, py, pz = subpixel_pads((2 * hx, 2 * hy, kz))
    fn = TCONV3D_SUBPIXEL.function()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w_sub.data_ptr(), b_sub.data_ptr(), out.data_ptr(),
            B, X, Y, Z, cin, hx, hy, kz, px, py, pz, cout, *out.shape[1:],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tconv3d_subpixel kernel launch failed: CUDA error {rc}")
    TCONV3D_SUBPIXEL.add()
    return out
