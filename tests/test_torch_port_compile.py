"""The port's serving forward against the JAX package's on the variants of
``tests/test_serving_compile.py``: the reference skip bug, a batch of two
tiles, a 2D config that falls back to the plain forward, and the subpixel
route of the transposed convs.  atol 5e-5, as in
``test_torch_port_unet.py``."""

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.infer.compile import (
    compile_serving_apply,
    subpixel_tconv_weights,
    tconv_subpixel,
)
from hcunet_tpu_torch.ops.conv import conv_transpose_torch
from tests.torch_port_support import SMALL, assert_forwards_match, jax_unet, port_unet

PRODUCTION = (156, 156, 10)

# name: (config kwargs, tile spatial, batch, serving kwargs)
CASES = {
    "reference_skip_bug": (dict(reference_skip_bug=True), PRODUCTION, 1, {}),
    "small_net_batch2": (SMALL, (48, 48, 8), 2, {}),
    "2d_plain_fallback": (
        dict(
            image_dimensions=2, feature_sizes=(8, 16), kernel1=(3, 3),
            kernel2=(3, 3), upsample_kernel=(2, 2), max_pool_kernel=(2, 2),
            upsample_stride=(2, 2), groups=1,
        ),
        (36, 36), 2, {},
    ),
    "production_3d_subpixel_tconv": ({}, PRODUCTION, 1, dict(subpixel_tconv=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_serving_variants_match_jax(name):
    kw, spatial, batch, serving = CASES[name]
    assert_forwards_match(jax_unet(kw, spatial), spatial, batch, **serving)


def test_subpixel_route_matches_the_transposed_conv_route():
    """The port's two routes of the transposed convs at production_3d on
    one (156, 156, 10) tile, float32: the parity convs through K1's plain
    version against ``F.conv_transpose3d``."""
    cfg, _jmodel, variables = jax_unet({}, PRODUCTION)
    model = port_unet(cfg, variables)
    x = torch.from_numpy(
        np.random.default_rng(2).random((1, *PRODUCTION, cfg.in_channels), np.float32)
    )
    routes = [
        compile_serving_apply(model, dtype=torch.float32, device="cpu", subpixel_tconv=s)(x)
        for s in (False, True)
    ]
    assert routes[0].shape == routes[1].shape == (1, 110, 110, 6, 1)
    np.testing.assert_allclose(routes[1].numpy(), routes[0].numpy(), atol=5e-5, rtol=0)


def test_subpixel_route_gate_matches_jax():
    """Only a stride-(2, 2) transposed conv with an even x/y kernel takes
    the subpixel route; an odd kernel keeps the transposed conv, as in the
    JAX function, so the output is the same either way."""
    kw = dict(SMALL, upsample_kernel=(3, 3, 2))
    cfg = UNetConfig(**kw)
    _c, _j, variables = jax_unet(kw, (48, 48, 8))
    model = port_unet(cfg, variables)
    calls = []

    def conv(x, w, b, relu):
        calls.append(tuple(w.shape))
        from hcunet_tpu_torch.ops.conv import conv3d_valid_plain

        return conv3d_valid_plain(x, w, b, relu)

    x = torch.rand((1, 48, 48, 8, cfg.in_channels), generator=torch.Generator().manual_seed(0))
    a = compile_serving_apply(model, dtype=torch.float32, device="cpu", conv=conv)(x)
    b = compile_serving_apply(
        model, dtype=torch.float32, device="cpu", conv=conv, subpixel_tconv=True
    )(x)
    assert len(calls) == 2 * 7  # the 7 valid convs, twice; no parity conv
    assert torch.equal(a, b)


# (x of the transposed conv [B, X, Y, Z, Cin], Cout) at the three up levels of
# a production_3d (156, 156, 10) tile
UP_LEVELS = [((1, 12, 12, 6, 128), 64), ((1, 26, 26, 6, 64), 32), ((1, 54, 54, 6, 32), 16)]


@pytest.mark.parametrize("x_shape,cout", UP_LEVELS, ids=["up0", "up1", "up2"])
def test_stacked_parity_weights_are_the_transposed_conv(x_shape, cout):
    """Pad, one conv with the stacked parity kernels, interleave: the
    transposed conv with kernel (8, 8, 2), stride (2, 2, 1), at atol 1e-5."""
    g = torch.Generator().manual_seed(cout)
    cin = x_shape[-1]
    x = torch.randn(x_shape, generator=g)
    w = torch.randn((8, 8, 2, cin, cout), generator=g) / np.sqrt(8 * 8 * 2 * cin)
    b = torch.randn(cout, generator=g) * 0.1
    w_sub = subpixel_tconv_weights(w)
    assert w_sub.shape == (4, 4, 2, cin, 4 * cout)
    want = conv_transpose_torch(x, w, b, stride=(2, 2, 1))
    got = tconv_subpixel(x, w_sub, b.repeat(4))
    assert got.shape == want.shape == (1, 2 * x_shape[1] + 6, 2 * x_shape[2] + 6, 7, cout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
