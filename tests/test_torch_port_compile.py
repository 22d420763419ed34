"""The port's serving forward against the JAX package's on the variants of
``tests/test_serving_compile.py``: the reference skip bug, a batch of two
tiles, a 2D config that falls back to the plain forward, and the JAX
function's subpixel route of the transposed convs; K1's subpixel route
(``ops/tconv.py::tconv_subpixel``) against the transposed conv.  atol 5e-5,
as in ``test_torch_port_unet.py``."""

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.ops.conv import conv_transpose_torch
from hcunet_tpu_torch.ops.tconv import subpixel_tconv_weights, tconv_subpixel
from tests.torch_port_support import SMALL, assert_forwards_match, jax_unet

PRODUCTION = (156, 156, 10)

# name: (config kwargs, tile spatial, batch, the JAX serving compiler's kwargs)
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
    "production_3d_jax_subpixel": ({}, PRODUCTION, 1, dict(subpixel_tconv=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_serving_variants_match_jax(name):
    kw, spatial, batch, serving = CASES[name]
    assert_forwards_match(jax_unet(kw, spatial), spatial, batch, **serving)


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
