"""Serving forward: the inference-optimised U-Net pass (twin of
``hcunet_tpu/infer/compile.py::compile_serving_apply``).

Takes a :class:`~hcunet_tpu_torch.models.unet.UNet` and returns
``apply(tiles[B, tx, ty, tz, C]) -> float32 logits``, equal to the model's
eval forward up to BN-folding rounding:

* inference BN is folded into each conv's weights and bias once, on the
  host (grouped weights expanded to block-diagonal dense first);
* each of the valid convs is kernel K1 (:func:`~hcunet_tpu_torch.ops.conv.conv3d_valid`)
  with the folded bias and the ReLU in its epilogue;
* the transposed convs take one of two routes, picked from the dtype, the
  stride, the kernel and the widths: in float32, where every up level is a
  stride-(2, 2) transposed conv with an even x/y kernel and widths the
  kernel takes, :func:`~hcunet_tpu_torch.ops.tconv.tconv3d_subpixel` (the
  four parity kernels stacked along Cout), which writes it straight into
  the up level's concat buffer; otherwise ``F.conv_transpose3d``;
* pools and the crop-and-concat at the skips are plain PyTorch,
  channels-last throughout.

The JAX function's z-block lane packing was sized for the TPU's 128-lane
matrix unit and is not carried over: only its contract is.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

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
from hcunet_tpu_torch.ops.tconv import (
    subpixel_pads,
    subpixel_tconv_weights,
    tconv3d_subpixel,
    tconv3d_subpixel_extent,
    tconv3d_subpixel_takes,
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


def compile_serving_apply(
    model: UNet,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    conv: Callable = conv3d_valid,
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

    In float32, with an x/y upsample stride of (2, 2) and an even x/y
    upsample kernel (where the JAX function can take its subpixel route)
    and widths that :func:`~hcunet_tpu_torch.ops.tconv.tconv3d_subpixel_takes`
    at every up level, the transposed convs run through
    :func:`~hcunet_tpu_torch.ops.tconv.tconv3d_subpixel`, into the buffer
    that the skip's channels then fill (:func:`_up_concat`), whatever
    ``conv`` is (a forward on the plain conv still launches that kernel on
    a CUDA tensor).  Elsewhere, bfloat16 included, they are
    ``F.conv_transpose3d``.
    """
    dev = resolve_device(device)
    cfg: UNetConfig = model.config

    def rebuild(d):
        return compile_serving_apply(model, dtype=dtype, device=d, conv=conv)

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

    use_kernel = (
        dtype == torch.float32
        and tuple(cfg.upsample_stride[:2]) == (2, 2)
        and subpixel_pads(cfg.upsample_kernel) is not None
        and all(tconv3d_subpixel_takes(cin, cout)
                for cout, cin in zip(cfg.feature_sizes, cfg.feature_sizes[1:]))
    )
    downs = [block(step) for step in model.down_steps]
    ups = []
    for step in model.up_steps:
        w_up = tconv_weight_channels_last(step.up_conv.weight).detach().float().cpu()
        b_up = step.up_conv.bias.detach().float().cpu()
        if use_kernel:
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
            skip = skips.pop()
            if use_kernel:
                x = _up_concat(x, w_up, b_up, skip, cfg.reference_skip_bug)
            else:
                x = conv_transpose_torch(
                    x, w_up, b_up, stride=cfg.upsample_stride, accum_dtype=dtype
                )
                common = [min(a, s) for a, s in zip(x.shape[1:-1], skip.shape[1:-1])]
                x = crop_spatial(x, common)
                joined = x if cfg.reference_skip_bug else crop_spatial(skip, common)
                x = torch.cat([x, joined], dim=-1)
            for w, b in convs:
                x = conv(x, w, b, True)
        return conv(x, w_out, b_out, False).float()

    return _bound(apply_fn, dev, rebuild)


def _up_concat(x, w_sub, b_sub, skip, skip_bug: bool) -> torch.Tensor:
    """An up level's input: the transposed conv of ``x`` (stacked parity
    kernels ``w_sub``, bias ``b_sub``) and the skip, each cropped to the
    extent they share, side by side along the channels, as ``torch.cat``
    would give them.  :func:`tconv3d_subpixel` writes the transposed conv
    into the first half of one buffer and the skip's top-left crop fills
    the second (with the reference's skip bug, the first half again)."""
    cout = w_sub.shape[-1] // 4
    extent = tconv3d_subpixel_extent(x.shape, w_sub.shape)
    common = [min(a, s) for a, s in zip(extent, skip.shape[1:-1])]
    joined = torch.empty((x.shape[0], *common, 2 * cout), dtype=x.dtype, device=x.device)
    tconv3d_subpixel(x, w_sub, b_sub, joined)
    joined[..., cout:] = joined[..., :cout] if skip_bug else crop_spatial(skip, common)
    return joined


def _bound(apply_fn, device, rebuild):
    """``apply_fn`` with the device it runs on and ``on_device(d)``, the
    same forward built on device ``d``: a mesh gives each of its devices a
    copy (:func:`hcunet_tpu_torch.parallel.mesh.replicate`)."""
    apply_fn.device = device
    apply_fn.on_device = rebuild
    return apply_fn
