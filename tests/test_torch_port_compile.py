"""The port's serving forward against the JAX package's on the variants of
``tests/test_serving_compile.py``: the reference skip bug, a batch of two
tiles, and a 2D config that falls back to the plain forward.  atol 5e-5, as
in ``test_torch_port_unet.py``."""

import pytest

from tests.torch_port_support import SMALL, assert_forwards_match, jax_unet

CASES = {
    "reference_skip_bug": (dict(reference_skip_bug=True), (156, 156, 10), 1),
    "small_net_batch2": (SMALL, (48, 48, 8), 2),
    "2d_plain_fallback": (
        dict(
            image_dimensions=2, feature_sizes=(8, 16), kernel1=(3, 3),
            kernel2=(3, 3), upsample_kernel=(2, 2), max_pool_kernel=(2, 2),
            upsample_stride=(2, 2), groups=1,
        ),
        (36, 36), 2,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_serving_variants_match_jax(name):
    kw, spatial, batch = CASES[name]
    assert_forwards_match(jax_unet(kw, spatial), spatial, batch)
