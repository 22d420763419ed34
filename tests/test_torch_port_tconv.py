"""The float32 transposed conv's kernel route (``ops/tconv.py``), on the CPU.

``compile_serving_apply`` runs each stride-(2, 2, 1) transposed conv with an
even x/y kernel of a float32 forward through ``tconv3d_subpixel``, which
writes it into the up level's concat buffer (the kernel
``csrc/tconv3d_subpixel.cu`` on the card, ``F.conv_transpose3d`` here);
bfloat16, an odd kernel and widths the kernel does not take (at any up
level) keep ``F.conv_transpose3d``.  The kernel itself is held to the plain
version in ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.infer import compile as compile_mod
from hcunet_tpu_torch.models.unet import crop_spatial, init_unet
from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv_transpose_torch
from hcunet_tpu_torch.ops.tconv import (
    TCONV3D_SUBPIXEL,
    subpixel_tconv_weights,
    tconv3d_subpixel,
    tconv3d_subpixel_extent,
    transposed_conv_weights,
)
from tests.torch_port_support import SMALL


@pytest.mark.parametrize("kernel", [(8, 8, 2), (4, 4, 2), (6, 6, 5), (2, 2, 1), (4, 6, 3)])
def test_unstacking_inverts_the_parity_stacking(kernel):
    w = torch.randn((*kernel, 3, 5), generator=torch.Generator().manual_seed(0))
    back = transposed_conv_weights(subpixel_tconv_weights(w))
    assert back.is_contiguous()
    assert torch.equal(back, w)


# (x [B, X, Y, Z, Cin], Cout, kernel, skip extent): the skip as large as the
# transposed conv's output (up0 of a production tile at a small scale), a
# skip smaller on every axis, and one larger on one axis and smaller on two
CONCAT_CASES = {
    "common_is_the_output": ((1, 6, 5, 4, 8), 4, (8, 8, 2), (19, 17, 5)),
    "common_below_the_output": ((2, 5, 6, 3, 8), 8, (8, 8, 2), (14, 15, 3)),
    "skip_larger_on_x": ((1, 4, 4, 3, 4), 4, (4, 4, 2), (13, 7, 2)),
}


@pytest.mark.parametrize("skip_bug", [False, True], ids=["skip", "reference_skip_bug"])
@pytest.mark.parametrize("case", sorted(CONCAT_CASES))
def test_concat_buffer_is_the_cat_bit_for_bit(case, skip_bug):
    """The plain version written into the concat buffer (channels 0 ..
    Cout - 1, channel stride 2 Cout) and the skip's crop in the other half
    equal ``torch.cat`` of the cropped transposed conv and the cropped skip
    exactly; with the reference's skip bug the second half is the first."""
    xs, cout, kernel, skip_extent = CONCAT_CASES[case]
    g = torch.Generator().manual_seed(len(case))
    x = torch.randn(xs, generator=g)
    w_up = torch.randn((*kernel, xs[-1], cout), generator=g)
    b = torch.randn(cout, generator=g)
    skip = torch.randn((xs[0], *skip_extent, cout), generator=g)
    y = conv_transpose_torch(x, w_up, b, stride=(2, 2, 1))
    common = [min(a, s) for a, s in zip(y.shape[1:4], skip.shape[1:4])]
    first = crop_spatial(y, common)
    want = torch.cat([first, first if skip_bug else crop_spatial(skip, common)], dim=-1)
    before = (TCONV3D_SUBPIXEL.launches, CONV3D_VALID.launches)
    got = compile_mod._up_concat(x, subpixel_tconv_weights(w_up), b.repeat(4), skip, skip_bug)
    assert (TCONV3D_SUBPIXEL.launches, CONV3D_VALID.launches) == before  # nothing launched
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.fixture
def routes(monkeypatch):
    """Calls of the two transposed-conv routes of the serving forward."""
    seen = []
    for name in ("tconv3d_subpixel", "conv_transpose_torch"):
        inner = getattr(compile_mod, name)

        def record(*args, _inner=inner, _name=name, **kwargs):
            seen.append(_name)
            return _inner(*args, **kwargs)

        monkeypatch.setattr(compile_mod, name, record)
    return seen


ROUTE_CASES = {
    # (config over SMALL, serving dtype, the route taken)
    "float32_even_kernel": ({}, torch.float32, "tconv3d_subpixel"),
    "float32_production_widths": (dict(feature_sizes=(16, 32)), torch.float32,
                                  "tconv3d_subpixel"),
    "float32_reference_skip_bug": (dict(reference_skip_bug=True), torch.float32,
                                   "tconv3d_subpixel"),
    "bfloat16": ({}, torch.bfloat16, "conv_transpose_torch"),
    "odd_kernel": (dict(upsample_kernel=(3, 3, 2)), torch.float32, "conv_transpose_torch"),
    "widths_not_multiples_of_4": (dict(feature_sizes=(6, 12)), torch.float32,
                                  "conv_transpose_torch"),
    # Cin 10 refused before Cout (each level's widths double, so a Cin off
    # the rule comes with an odd Cout)
    "cin_not_a_multiple_of_4": (dict(feature_sizes=(5, 10)), torch.float32,
                                "conv_transpose_torch"),
    # 24 -> 12 taken alone, 12 -> 6 refused: both levels keep the transposed conv
    "one_level_refused": (dict(feature_sizes=(6, 12, 24)), torch.float32,
                          "conv_transpose_torch"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_serving_route_of_the_transposed_convs(routes, case):
    """The route follows what the forward can observe: the dtype, the
    stride and kernel (``subpixel_pads``) and the widths of every up level;
    one call per up level."""
    kw, dtype, want = ROUTE_CASES[case]
    cfg = UNetConfig(**{**SMALL, **kw})
    model = init_unet(cfg, torch.Generator().manual_seed(0)).eval()
    apply = compile_mod.compile_serving_apply(model, dtype=dtype, device="cpu")
    x = torch.rand((1, 48, 48, 8, cfg.in_channels), generator=torch.Generator().manual_seed(1))
    out = apply(x)
    assert routes == [want] * (len(cfg.feature_sizes) - 1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# name: (the config, the tiles [B, X, Y, Z])
FORWARD_CASES = {
    "small_two_tiles": (UNetConfig(**{**SMALL, "feature_sizes": (8, 16, 32)}), (2, 60, 60, 8)),
    "production_3d": (UNetConfig.production_3d(), (1, 156, 156, 10)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_kernel_route_equals_the_model_forward(case):
    """The float32 serving forward through the kernel route's plain version
    against the model's own eval forward (BN unfolded, the transposed
    convs on ``F.conv_transpose3d``)."""
    cfg, tiles = FORWARD_CASES[case]
    model = init_unet(cfg, torch.Generator().manual_seed(2)).eval()
    x = torch.rand((*tiles, cfg.in_channels), generator=torch.Generator().manual_seed(3))
    got = compile_mod.compile_serving_apply(model, dtype=torch.float32, device="cpu")(x)
    with torch.no_grad():
        want = model(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("kernel", [(8, 8, 2), (4, 6, 3)])
def test_extent_is_the_transposed_convs(kernel):
    x = torch.zeros((1, 5, 4, 3, 2))
    w_up = torch.zeros((*kernel, 2, 1))
    y = conv_transpose_torch(x, w_up, stride=(2, 2, 1))
    assert tconv3d_subpixel_extent(x.shape, subpixel_tconv_weights(w_up).shape) == y.shape[1:4]
    assert tconv3d_subpixel_extent((6, 54, 54, 19, 128), (4, 4, 2, 128, 256)) == (114, 114, 20)


def test_wrapper_refuses_a_device_without_the_kernel():
    x = torch.empty((1, 4, 4, 3, 4), device="meta")
    w_sub = torch.empty((4, 4, 2, 4, 16), device="meta")
    out = torch.empty((1, 14, 14, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tconv3d_subpixel(x, w_sub, torch.empty(16, device="meta"), out)
