"""``Segmenter.predict`` of the port against the JAX package's, on the same
numpy volume and weights, through shape bucketing, the BN-folded forward
and the epilogue.  Tolerances as in ``test_torch_port_tiling.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.infer.serving import Segmenter as JaxSegmenter
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.infer.serving import Segmenter
from tests.torch_port_support import SMALL, jax_unet, port_unet

TILE = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=4)


@pytest.fixture(scope="module")
def unet():
    return jax_unet(SMALL, (48, 56, 12))


# volume (40, 50, 9) buckets to (48, 72, 16) by symmetric padding; (14, 50, 9)
# stays 14 on x (smaller than the core) and clamps the halo there
CASES = {
    "probability": ((40, 50, 9), dict(use_probability_map=True), 1e-5),
    "postprocess": (
        (40, 50, 9), dict(use_probability_map=True, postprocess=(1.0, 0.3, 10.0)), 1e-4,
    ),
    "small_volume": ((14, 50, 9), dict(use_probability_map=True), 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmenter_predict_matches_jax(unet, case):
    shape, kw, atol = CASES[case]
    cfg, jmodel, variables = unet
    vol = np.random.default_rng(3).random((*shape, 4), dtype=np.float32)
    want = JaxSegmenter(
        jmodel, variables, JaxTileConfig(**TILE), dtype=jnp.float32, **kw
    ).predict(vol)
    # the port takes the JAX variable tree as it is
    seg = Segmenter(
        port_unet(cfg, variables), variables, TileConfig(**TILE), device="cpu", **kw
    )
    assert seg.bucket_shape(shape) == JaxSegmenter(
        jmodel, variables, JaxTileConfig(**TILE)
    ).bucket_shape(shape)
    got = seg.predict(vol)
    assert got.shape == want.shape == shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def test_segmenter_threshold_and_plain_forward_match_jax(unet):
    """uint8 masks, with ``packed=False`` (the model's plain forward) on both
    sides; equal except where |p - 0.5| < 1e-5."""
    cfg, jmodel, variables = unet
    vol = np.random.default_rng(4).random((40, 50, 9, 4), dtype=np.float32)
    model = port_unet(cfg, variables)
    kw = dict(tile_cfg=TileConfig(**TILE), packed=False, device="cpu")
    got = Segmenter(model, use_probability_map=False, **kw).predict(vol)
    prob = Segmenter(model, use_probability_map=True, **kw).predict(vol)
    want = JaxSegmenter(
        jmodel, variables, JaxTileConfig(**TILE), use_probability_map=False,
        packed=False,
    ).predict(vol)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.all(np.abs(prob[got != np.asarray(want)] - 0.5) < 1e-5)


def test_segmenter_warmup_and_state_dict_weights(unet):
    cfg, _, variables = unet
    model = port_unet(cfg, variables)
    seg = Segmenter(
        port_unet(cfg, variables), model.state_dict(), TileConfig(**TILE), device="cpu"
    )
    seg.warmup([(20, 30, 9)])
    ref = Segmenter(model, tile_cfg=TileConfig(**TILE), device="cpu")
    vol = np.random.default_rng(5).random((20, 30, 9, 4), dtype=np.float32)
    np.testing.assert_array_equal(seg.predict(vol), ref.predict(vol))
