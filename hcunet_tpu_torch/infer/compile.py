"""Serving forward: the inference-optimised U-Net pass (twin of
``hcunet_tpu/infer/compile.py::compile_serving_apply``).

Takes a :class:`~hcunet_tpu_torch.models.unet.UNet` and returns
``apply(tiles[B, tx, ty, tz, C]) -> float32 logits``, equal to the model's
eval forward up to BN-folding rounding:

* inference BN is folded into each conv's weights and bias once, on the
  host (grouped weights expanded to block-diagonal dense first);
* each of the valid convs is kernel K1 (:func:`~hcunet_tpu_torch.ops.conv.conv3d_valid`)
  with the folded bias and the ReLU in its epilogue;
* transpose convs are ``F.conv_transpose3d`` by default; with
  ``subpixel_tconv=True`` each stride-(2, 2) one with an even x/y kernel
  runs as its four parity valid convs, stacked along Cout into one K1
  launch, plus an interleave (:func:`tconv_subpixel`);
* pools and the crop-and-concat at the skips are plain PyTorch,
  channels-last throughout.

The JAX function's z-block lane packing was sized for the TPU's 128-lane
matrix unit and is not carried over: only its contract is.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from hcunet_tpu_torch.config import UNetConfig, resolve_device
from hcunet_tpu_torch.models.unet import (
    UNet,
    conv_weight_channels_last,
    crop_spatial,
    tconv_weight_channels_last,
)
from hcunet_tpu_torch.ops.conv import (
    block_diagonal_weights,
    conv3d_valid,
    conv_transpose_torch,
    fold_bn_into_conv,
    max_pool,
)

_Folded = Tuple[torch.Tensor, torch.Tensor]  # weights [*k, Cin, Cout], f32 bias


@torch.no_grad()
def _folded_conv_params(conv, bn, groups: int, dtype, device) -> _Folded:
    """Conv weights with inference BN folded in, computed in float32 on the
    host, then moved to ``device``: weights in ``dtype``, bias in float32."""
    w = conv_weight_channels_last(conv.weight).detach().float().cpu()
    if groups > 1:
        w = block_diagonal_weights(w, groups)
    w_f, b_f = fold_bn_into_conv(
        w, conv.bias.detach().float().cpu(),
        bn.weight.detach().cpu(), bn.bias.detach().cpu(),
        bn.running_mean.cpu(), bn.running_var.cpu(), bn.eps,
    )
    return (
        w_f.to(device=device, dtype=dtype).contiguous(),
        b_f.to(device=device).contiguous(),
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


def compile_serving_apply(
    model: UNet,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    conv: Callable = conv3d_valid,
    subpixel_tconv: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the BN-folded inference forward for a 3D valid-conv UNet.

    Returns ``apply(tiles[B, tx, ty, tz, C]) -> logits`` (float32) on
    ``device`` (CUDA unless given); ``apply.device`` names that device and
    ``apply.on_device(d)`` builds the same forward on device ``d``.
    ``conv`` runs the valid convs with the signature of
    :func:`conv3d_valid`; K1 by default.  Falls back to the
    model's plain forward where the JAX function does: 2D configs,
    dilation > 1, a z upsample stride other than 1 or a pool other than
    (2, 2, 1).

    ``subpixel_tconv=True`` runs each transposed conv through
    :func:`tconv_subpixel` (one ``conv`` call per up level) where the JAX
    function takes its subpixel route: an x/y upsample stride of (2, 2) and
    an even x/y upsample kernel; elsewhere, and by default as in JAX, the
    transposed convs are ``F.conv_transpose3d``.
    """
    dev = resolve_device(device)
    cfg: UNetConfig = model.config

    def rebuild(d):
        return compile_serving_apply(
            model, dtype=dtype, device=d, conv=conv, subpixel_tconv=subpixel_tconv
        )

    if (
        cfg.image_dimensions != 3
        or cfg.dilation != 1
        or cfg.upsample_stride[2] != 1
        or tuple(cfg.max_pool_kernel) != (2, 2, 1)
    ):
        plain = UNet(cfg, dtype=dtype)
        plain.load_state_dict(model.state_dict())
        plain.to(dev).eval()

        @torch.no_grad()
        def plain_apply(tiles: torch.Tensor) -> torch.Tensor:
            return plain(tiles.to(dev))

        return _bound(plain_apply, dev, rebuild)

    def block(step) -> List[_Folded]:
        return [
            _folded_conv_params(step.conv1, step.batch1, cfg.groups, dtype, dev),
            _folded_conv_params(step.conv2, step.batch2, cfg.groups, dtype, dev),
        ]

    use_subpixel = (
        subpixel_tconv
        and tuple(cfg.upsample_stride[:2]) == (2, 2)
        and subpixel_pads(cfg.upsample_kernel) is not None
    )
    downs = [block(step) for step in model.down_steps]
    ups = []
    for step in model.up_steps:
        w_up = tconv_weight_channels_last(step.up_conv.weight).detach().float().cpu()
        b_up = step.up_conv.bias.detach().float().cpu()
        if use_subpixel:
            w_up, b_up = subpixel_tconv_weights(w_up), b_up.repeat(4)
        ups.append((
            w_up.to(device=dev, dtype=dtype).contiguous(),
            b_up.to(dev),
            block(step),
        ))
    w_out = conv_weight_channels_last(model.out_conv.weight).detach()
    w_out = w_out.to(device=dev, dtype=dtype).contiguous()
    b_out = model.out_conv.bias.detach().float().to(dev)
    n_levels = len(cfg.feature_sizes)

    @torch.no_grad()
    def apply_fn(tiles: torch.Tensor) -> torch.Tensor:
        x = tiles.to(device=dev, dtype=dtype).contiguous()
        skips = []
        for i, convs in enumerate(downs):
            for w, b in convs:
                x = conv(x, w, b, True)
            if i < n_levels - 1:
                skips.append(x)
                x = max_pool(x, cfg.max_pool_kernel)
        for w_up, b_up, convs in ups:
            if use_subpixel:
                x = tconv_subpixel(x, w_up, b_up, conv)
            else:
                x = conv_transpose_torch(
                    x, w_up, b_up, stride=cfg.upsample_stride, accum_dtype=dtype
                )
            skip = skips.pop()
            common = [min(a, s) for a, s in zip(x.shape[1:-1], skip.shape[1:-1])]
            x = crop_spatial(x, common)
            joined = x if cfg.reference_skip_bug else crop_spatial(skip, common)
            x = torch.cat([x, joined], dim=-1)
            for w, b in convs:
                x = conv(x, w, b, True)
        return conv(x, w_out, b_out, False).float()

    return _bound(apply_fn, dev, rebuild)


def _bound(apply_fn, device, rebuild):
    """``apply_fn`` with the device it runs on and ``on_device(d)``, the
    same forward built on device ``d``: a mesh gives each of its devices a
    copy (:func:`hcunet_tpu_torch.parallel.mesh.replicate`)."""
    apply_fn.device = device
    apply_fn.on_device = rebuild
    return apply_fn
