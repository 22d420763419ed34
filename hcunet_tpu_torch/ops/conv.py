"""Convolution primitives for the valid-conv U-Net family
(twin of ``hcunet_tpu/ops/conv.py``).

Channels-last layouts as in the JAX package: activations ``[B, *spatial, C]``,
conv weights ``[*k, Cin/groups, Cout]``, transpose-conv weights
``[*k, Cin, Cout]``.

The valid conv is kernel K1, ``csrc/conv3d_valid.cu``, a hand-written CUDA
implicit GEMM with the bias and ReLU in its epilogue.  It has two paths
(:func:`conv3d_valid_route`): a cp.async ring feeding wgmma for bfloat16
with ``Cin % 8 == 0``, and a basic one for the rest.  :func:`conv3d_valid`
launches it for a CUDA tensor and raises if it cannot; only a tensor on the
CPU takes :func:`conv3d_valid_plain`, the same function in plain PyTorch.

A conv that needs a gradient runs through :class:`Conv3dValidFunction`:
K1 in the forward, K1 again for the input gradient
(:func:`conv3d_valid_input_grad`, a valid conv of the padded output
gradient with the flipped kernel), and plain PyTorch (cuDNN's wgrad on
CUDA) for the weight gradient, which the JAX package also left to XLA.
The recurrent models' same-padding convs (:func:`conv_same`) are valid
convs of a zero-padded input, so at stride 1 they run on K1 too.
Transpose convs, strided convs and pooling are plain PyTorch, as the JAX
package left them to XLA.  :func:`batch_norm_train` is train-mode batch norm with flax's
semantics, and :func:`update_running_stats` flax's running update.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from hcunet_tpu_torch.csrc import CudaKernel, LaunchCount, aligned16

_P, _I = ctypes.c_void_p, ctypes.c_int

# K1's two paths, by the number its C entry point conv3d_valid_route gives:
# the C entry point decides, and conv3d_valid_route below names the same
# choice (a CUDA test holds the two to each other)
CONV3D_ROUTES = ("basic", "ring")

CONV3D_VALID = CudaKernel(
    "conv3d_valid.cu",
    "conv3d_valid",
    [_I, _P, _P, _P, _P] + [_I] * 13 + [_P],
    routes=CONV3D_ROUTES,
)

# K1 launched for the input gradient of a conv (conv3d_valid_input_grad),
# counted apart from CONV3D_VALID's forward launches
CONV3D_VALID_INPUT_GRAD = LaunchCount(CONV3D_ROUTES)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3d_valid_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The path K1 takes for a call, a function of (dtype, Cin, Cout) alone:
    ``"ring"`` (the cp.async ring feeding wgmma) for bfloat16 with
    ``Cin % 8 == 0``, else ``"basic"``.  The same rule as the C entry point
    ``conv3d_valid_route`` in ``csrc/conv3d_valid.cu``, which decides."""
    del cout  # no path depends on it yet
    return "ring" if dtype == torch.bfloat16 and cin % 8 == 0 else "basic"


def _tuple(v, n: int) -> Tuple[int, ...]:
    return (int(v),) * n if isinstance(v, int) else tuple(int(a) for a in v)


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1).contiguous()


def conv3d_valid_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    dilation: Sequence[int] | int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``F.conv3d`` in float32, plus the bias,
    optional ReLU, cast back to ``x``'s dtype.  Same arguments and layouts as
    :func:`conv3d_valid`."""
    wt = w.float().permute(4, 3, 0, 1, 2)  # [Cout, Cin, kx, ky, kz]
    out = F.conv3d(_to_channels_first(x.float()), wt, dilation=_tuple(dilation, 3))
    out = _to_channels_last(out)
    if bias is not None:
        out = out + bias.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def conv3d_valid(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    dilation: Sequence[int] | int = 1,
) -> torch.Tensor:
    """Valid 3D conv, channels-last, with float32 bias and optional ReLU.

    ``x`` ``[B, X, Y, Z, Cin]`` and ``w`` ``[kx, ky, kz, Cin, Cout]`` in
    float32 or bfloat16 (the same for both); ``bias`` ``[Cout]`` float32.
    Returns ``[B, Xo, Yo, Zo, Cout]`` in ``x``'s dtype, summed in float32.

    A CUDA tensor launches K1 (``csrc/conv3d_valid.cu``) on the path
    :func:`conv3d_valid_route` names; a CPU tensor runs
    :func:`conv3d_valid_plain`.  Any other device, or an input K1 does not
    take, raises.  The ring path copies 16 bytes at a time, so there an
    ``x`` or ``w`` that does not start on a 16-byte boundary (a view at an
    odd element offset) is first copied once into a fresh, aligned
    allocation; the basic path takes any contiguous input as it is.

    With grad mode on and an input that requires grad, the call runs through
    :class:`Conv3dValidFunction`, which takes no ``bias`` and no ``relu``
    (what :func:`conv_valid` passes); with either it raises, so that no
    output ever comes back without its gradient.
    """
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias)
    ):
        if bias is not None or relu:
            raise ValueError(
                "conv3d_valid: the gradient path takes no bias and no relu; "
                "run the serving path under torch.no_grad()"
            )
        return Conv3dValidFunction.apply(x, w, _tuple(dilation, 3))
    if x.device.type == "cpu":
        return conv3d_valid_plain(x, w, bias, relu, dilation)
    y, route = _k1_launch(x, w, bias, relu, _tuple(dilation, 3))
    if route is not None:
        CONV3D_VALID.add(route)
    return y


def _k1_launch(x, w, bias, relu, dil) -> Tuple[torch.Tensor, Optional[str]]:
    """Check K1's inputs and launch it; returns the output and the path
    (None when the batch is empty and nothing launched).  The callers count
    the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_valid: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"conv3d_valid takes float32 or bfloat16 x and w of one dtype, "
            f"got {x.dtype} and {w.dtype}"
        )
    if x.ndim != 5 or w.ndim != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(
            f"conv3d_valid: x [B,X,Y,Z,Cin] and w [kx,ky,kz,Cin,Cout] "
            f"expected, got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    B, X, Y, Z, cin = x.shape
    kx, ky, kz, _, cout = w.shape
    out_sp = [s - d * (k - 1) for s, d, k in zip((X, Y, Z), dil, (kx, ky, kz))]
    if min(out_sp) <= 0:
        raise ValueError(f"conv3d_valid: input {tuple(x.shape)} smaller than kernel")
    if bias is None:
        bias = torch.zeros(cout, device=x.device, dtype=torch.float32)
    if bias.dtype != torch.float32 or bias.shape != (cout,):
        raise TypeError(f"conv3d_valid: bias must be float32 [{cout}]")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"conv3d_valid: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv3d_valid: {name} must be contiguous")
    y = torch.empty((B, *out_sp, cout), device=x.device, dtype=x.dtype)
    if B == 0:
        return y, None
    route = conv3d_valid_route(x.dtype, cin, cout)
    if route == "ring":
        x, w = aligned16(x), aligned16(w)
    fn = CONV3D_VALID.function()
    dt = _KERNEL_DTYPES[x.dtype]
    # the launch goes to the current device, which must be x's
    with torch.cuda.device(x.device):
        rc = fn(
            dt, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            y.data_ptr(), B, X, Y, Z, cin, kx, ky, kz, *dil, cout, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3d_valid kernel launch failed: CUDA error {rc}")
    return y, route


def _input_grad_operands(gy: torch.Tensor, w: torch.Tensor, dil) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valid conv whose output is the input gradient: ``gy`` zero-padded
    by ``dilation * (k - 1)`` on both sides of each spatial axis (one
    allocation), and the kernel flipped in space with Cin and Cout swapped,
    ``[kx, ky, kz, Cout, Cin]``."""
    pads = [d * (k - 1) for d, k in zip(dil, w.shape[:3])]
    B, X, Y, Z, cout = gy.shape
    padded = gy.new_zeros((B, *(s + 2 * p for s, p in zip((X, Y, Z), pads)), cout))
    px, py, pz = pads
    padded[:, px : px + X, py : py + Y, pz : pz + Z] = gy
    return padded, w.flip((0, 1, 2)).transpose(3, 4).contiguous()


def conv3d_valid_input_grad_plain(
    gy: torch.Tensor, w: torch.Tensor, dilation: Sequence[int] | int = 1
) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3d_valid_input_grad`: the same
    padded, flipped conv through :func:`conv3d_valid_plain`."""
    padded, wt = _input_grad_operands(gy, w, _tuple(dilation, 3))
    return conv3d_valid_plain(padded, wt, dilation=dilation)


def conv3d_valid_input_grad(
    gy: torch.Tensor, w: torch.Tensor, dilation: Sequence[int] | int = 1
) -> torch.Tensor:
    """The gradient of ``conv3d_valid(x, w)`` with respect to ``x``, for the
    output gradient ``gy`` ``[B, Xo, Yo, Zo, Cout]``: ``[B, X, Y, Z, Cin]``
    in ``gy``'s dtype, summed in float32.

    ``dx[i] = sum_k gy[i - d k] w[k]`` is itself a valid conv: of ``gy``
    zero-padded by ``d (k - 1)`` on both sides, with the flipped kernel and
    Cin/Cout swapped.  A CUDA tensor launches K1 for it (counted in
    ``CONV3D_VALID_INPUT_GRAD``, on the path ``conv3d_valid_route`` names
    for Cin' = Cout); a CPU tensor runs the plain version."""
    dil = _tuple(dilation, 3)
    if gy.device.type == "cpu":
        return conv3d_valid_input_grad_plain(gy, w, dil)
    if w.dtype != gy.dtype:
        raise TypeError(f"conv3d_valid_input_grad: gy {gy.dtype}, w {w.dtype}")
    padded, wt = _input_grad_operands(gy, w, dil)
    dx, route = _k1_launch(padded, wt, None, False, dil)
    if route is not None:
        CONV3D_VALID_INPUT_GRAD.add(route)
    return dx


def conv3d_valid_weight_grad(
    x: torch.Tensor, gy: torch.Tensor, w_shape: Sequence[int], dilation: Sequence[int] | int = 1
) -> torch.Tensor:
    """The gradient of ``conv3d_valid(x, w)`` with respect to ``w``
    ``[kx, ky, kz, Cin, Cout]``, in ``x``'s dtype: plain PyTorch
    (``torch.nn.grad.conv3d_weight``, cuDNN's wgrad on CUDA, in ``x``'s
    dtype; float32 on the CPU).  No TPU kernel computes it: the JAX package
    leaves it to XLA."""
    kx, ky, kz, cin, cout = w_shape
    work = torch.float32 if x.device.type == "cpu" else x.dtype
    dw = torch.nn.grad.conv3d_weight(
        _to_channels_first(x.to(work)), (cout, cin, kx, ky, kz),
        _to_channels_first(gy.to(work)), dilation=_tuple(dilation, 3),
    )
    return dw.permute(2, 3, 4, 1, 0).to(x.dtype)


class Conv3dValidFunction(torch.autograd.Function):
    """``conv3d_valid(x, w)`` (no bias, no ReLU) with its gradient: the
    forward and the input gradient through K1 on CUDA, the weight gradient
    through :func:`conv3d_valid_weight_grad`.  The input gradient is skipped
    where ``x`` needs none (a network's first layer)."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.dilation = dilation
        ctx.save_for_backward(x, w)
        return conv3d_valid(x, w, None, False, dilation)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv3d_valid_input_grad(gy, w, ctx.dilation)
        if ctx.needs_input_grad[1]:
            gw = conv3d_valid_weight_grad(x, gy, w.shape, ctx.dilation)
        return gx, gw, None


def block_diagonal_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Expand grouped-conv weights ``[*k, Cin/g, Cout]`` to dense
    block-diagonal ``[*k, Cin, Cout]``: numerically the grouped conv, with
    the cross-group weights structurally zero."""
    k = w.shape[:-2]
    cin_g, cout = w.shape[-2], w.shape[-1]
    cout_g = cout // groups
    dense = w.new_zeros((*k, cin_g * groups, cout))
    for j in range(groups):
        dense[..., j * cin_g : (j + 1) * cin_g, j * cout_g : (j + 1) * cout_g] = (
            w[..., :, j * cout_g : (j + 1) * cout_g]
        )
    return dense


# below this many groups, dense block-diagonal runs instead of a grouped conv
_GROUPED_DENSE_MAX_EXPANSION = 8


def conv_valid(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: Sequence[int] | int = 1,
    dilation: Sequence[int] | int = 1,
    groups: int = 1,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Valid convolution, channels-last.

    ``x``: ``[B, *spatial, Cin]``; ``w``: ``[*kspatial, Cin//groups, Cout]``.
    Returns the result in ``accum_dtype`` with ``b`` added.  Groups up to 8
    run as block-diagonal dense.  2D runs as 3D with a unit z axis.  Unit
    stride goes through :func:`conv3d_valid` (K1 on CUDA); a strided conv,
    or one with more than 8 groups, has no kernel yet and raises on CUDA.
    """
    nd = x.ndim - 2
    stride = _tuple(stride, nd)
    dilation = _tuple(dilation, nd)
    if 1 < groups <= _GROUPED_DENSE_MAX_EXPANSION:
        w = block_diagonal_weights(w, groups)
        groups = 1
    if groups == 1 and all(s == 1 for s in stride) and nd in (2, 3):
        x3, w3, dil3 = x, w, dilation
        if nd == 2:
            x3, w3, dil3 = x[..., None, :], w[:, :, None], (*dilation, 1)
        out = conv3d_valid(
            x3.contiguous(), w3.to(x.dtype).contiguous(), None, False, dil3
        )
        if nd == 2:
            out = out[..., 0, :]
        out = out.to(accum_dtype)
    else:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "conv_valid: strided or many-group convs have no CUDA kernel"
            )
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
        perm = (nd + 1, nd) + tuple(range(nd))  # -> [Cout, Cin/g, *k]
        out = conv(
            _to_channels_first(x.float()), w.float().permute(perm),
            stride=stride, dilation=dilation, groups=groups,
        )
        out = _to_channels_last(out).to(accum_dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def conv_same(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: Sequence[int] | int = 1,
    padding: Sequence[int] | int = 0,
    dilation: Sequence[int] | int = 1,
    relu: bool = False,
    accum_dtype: torch.dtype = torch.float32,
    conv: Callable = conv3d_valid,
) -> torch.Tensor:
    """3D convolution with explicit symmetric zero padding (torch
    ``padding=p``), channels-last: the recurrent models' conv
    (``hcat/r_unet.py``), twin of the JAX package's ``conv_same``.

    ``x`` ``[B, X, Y, Z, Cin]``, ``w`` ``[kx, ky, kz, Cin, Cout]``, ``b``
    ``[Cout]``.  At stride 1 the conv is a valid conv of ``x`` zero-padded
    by ``padding`` on both sides of each spatial axis (``F.pad``: one
    allocation and copy), run by ``conv`` (:func:`conv3d_valid`: K1 on
    CUDA, its plain version on the CPU) with ``b`` in float32 and
    ``relu`` in its epilogue; where a gradient is needed, ``b`` and the
    ReLU follow it instead (K1's gradient path takes neither).  A larger
    stride (RDCNet's input conv) is plain ``F.conv3d``, in ``x``'s dtype on
    CUDA and float32 on the CPU, as the JAX package left that conv to XLA.
    Returns ``accum_dtype``.
    """
    stride, padding, dilation = (_tuple(v, 3) for v in (stride, padding, dilation))
    if any(s != 1 for s in stride):
        work = torch.float32 if x.device.type == "cpu" else x.dtype
        out = F.conv3d(
            _to_channels_first(x.to(work)), w.to(work).permute(4, 3, 0, 1, 2),
            stride=stride, padding=padding, dilation=dilation,
        )
        out = _to_channels_last(out).to(accum_dtype)
    else:
        px, py, pz = padding
        xp = F.pad(x, (0, 0, pz, pz, py, py, px, px)).contiguous()
        w = w.to(x.dtype).contiguous()
        if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)
        )):
            bias = None if b is None else b.float().contiguous()
            return conv(xp, w, bias, relu, dilation).to(accum_dtype)
        out = conv(xp, w, None, False, dilation).to(accum_dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return torch.relu(out) if relu else out


def conv_transpose_torch(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: Sequence[int] | int = 1,
    padding: Sequence[int] | int = 0,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Transposed convolution with torch ``ConvTranspose{2,3}d`` semantics.

    ``w``: ``[*kspatial, Cin, Cout]`` (the same layout as :func:`conv_valid`).
    Runs in ``x``'s dtype on CUDA and in float32 on the CPU, and returns
    ``accum_dtype`` with ``b`` added.
    """
    nd = x.ndim - 2
    conv = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}[nd]
    work = torch.float32 if x.device.type == "cpu" else x.dtype
    wt = w.to(work).permute((nd, nd + 1) + tuple(range(nd)))  # [Cin, Cout, *k]
    out = conv(
        _to_channels_first(x.to(work)), wt,
        stride=_tuple(stride, nd), padding=_tuple(padding, nd),
    )
    out = _to_channels_last(out).to(accum_dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def max_pool(x: torch.Tensor, kernel: Sequence[int]) -> torch.Tensor:
    """Max pool with stride = kernel (torch ``MaxPool`` default)."""
    nd = x.ndim - 2
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
    k = _tuple(kernel, nd)
    return _to_channels_last(pool(_to_channels_first(x), k, k))


def batch_norm_inference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inference-mode batch norm folded to one multiply-add over the
    channel (last) axis, as torch ``BatchNorm.eval()`` with running stats."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    shift = bias.float() - mean.float() * inv
    return (x.float() * inv + shift).to(x.dtype)


# the thread's batch-statistics reduction over data replicas (None: the
# statistics are the local batch's); set by batch_stat_reduction
_BATCH_STATS = threading.local()


@contextlib.contextmanager
def batch_stat_reduction(reduce: Callable):
    """Within the block, in this thread, :func:`batch_norm_train` takes its
    statistics over the global batch of a data-parallel step:
    ``reduce(sums, count)`` maps this replica's ``[2, C]`` float32 sums of
    ``x`` and ``x * x`` and its element count per channel to the sums and
    the count over every replica (``hcunet_tpu_torch.parallel.train``)."""
    prev = getattr(_BATCH_STATS, "reduce", None)
    _BATCH_STATS.reduce = reduce
    try:
        yield
    finally:
        _BATCH_STATS.reduce = prev


def batch_norm_train(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode batch norm over ``channel_axis`` (the last by default;
    1 for NCHW) with flax ``nn.BatchNorm(use_running_average=False)``'s
    semantics: the statistics over every other axis, in float32, with the
    fast variance ``E[x^2] - E[x]^2`` clipped at 0 (biased); then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to ``x``'s
    dtype.  Returns ``(y, mean, var)``; the gradient flows through the
    statistics.  (``F.batch_norm`` keeps the unbiased variance for its
    running update, so the caller updates the running statistics itself,
    with :func:`update_running_stats`.)  Inside
    :func:`batch_stat_reduction` the two means are over every replica's
    batch: their sums are reduced before the same formula."""
    xf = x.float()
    ax = channel_axis % x.ndim
    axes = tuple(i for i in range(x.ndim) if i != ax)
    shape = [1] * x.ndim
    shape[ax] = -1
    reduce = getattr(_BATCH_STATS, "reduce", None)
    if reduce is None:
        mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
    else:
        sums, count = reduce(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]),
                             xf.numel() // xf.shape[ax])
        mean, mean_sq = sums[0] / count, sums[1] / count
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean.view(shape)) * inv.view(shape) + bias.float().view(shape)
    return y.to(x.dtype), mean, var


def update_running_stats(bn, mean: torch.Tensor, var: torch.Tensor, momentum: float) -> None:
    """flax ``nn.BatchNorm``'s running update, into the buffers of ``bn``
    (a torch BatchNorm module): ``new = momentum * old + (1 - momentum) *
    batch`` for the mean and the biased variance of
    :func:`batch_norm_train`.  flax's ``momentum`` is torch's ``1 -
    momentum``: 0.9 in the U-Net and the recurrent family, flax's default
    0.99 in the detector's trunks."""
    with torch.no_grad():
        for buf, new in ((bn.running_mean, mean), (bn.running_var, var)):
            buf.copy_(momentum * buf + (1 - momentum) * new.detach())


def fold_bn_into_conv(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BN into the preceding conv's weights.

    ``w``: ``[*kspatial, Cin, Cout]``; stats are per-Cout.  Returns the
    folded weights in ``w``'s dtype and the folded bias in float32."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    w_f = w.float() * inv  # broadcast over the trailing Cout axis
    b0 = torch.zeros_like(mean, dtype=torch.float32) if b is None else b.float()
    b_f = (b0 - mean.float()) * inv + bias.float()
    return w_f.to(w.dtype), b_f
