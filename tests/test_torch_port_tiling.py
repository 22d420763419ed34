"""The slice end to end on the CPU: the port's tiled segmentation against the
JAX package's on the same volume and weights.

The model is the two-level net (shrink (14, 14, 2)) with random weights and
batch-norm statistics; the JAX side runs ``model.apply``, the port its
BN-folded serving forward, both in float32.  Tolerances: probabilities 1e-5
(float32 logits agree to ~1e-6 and the sigmoid's slope is at most 1/4);
after ``postprocess`` 1e-4, since the epilogue multiplies by ``scale=10``;
thresholded masks equal except where |p - 0.5| < 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.infer import tiling as jtiling
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.infer import tiling as ttiling
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from tests.torch_port_support import SMALL, jax_unet, port_unet

TILE = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=4)


@pytest.fixture(scope="module")
def nets():
    cfg, jmodel, variables = jax_unet(SMALL, (48, 56, 12))
    jcfg = jmodel.config
    japply = jax.tree_util.Partial(
        lambda v, t: jmodel.apply(v, t, train=False), variables
    )
    tapply = compile_serving_apply(
        port_unet(cfg, variables), dtype=torch.float32, device="cpu"
    )
    return cfg, jcfg, japply, tapply


def _volume(shape, seed=2):
    return np.random.default_rng(seed).random((1, *shape, 4), dtype=np.float32)


def _both(nets, vol, tile, **kw):
    cfg, jcfg, japply, tapply = nets
    want = jtiling.predict_segmentation_mask(
        japply, jnp.asarray(vol), jcfg, JaxTileConfig(**tile), **kw
    )
    got = ttiling.predict_segmentation_mask(
        tapply, vol, cfg, TileConfig(**tile), device="cpu", **kw
    )
    return got.numpy(), np.asarray(want)


# volume (40, 50, 9) on eval (16, 24, 8): a 3x3x2 grid with a ragged edge
# overhang on every axis and 18 tiles padded to 20 with dummy tiles
CASES = {
    "ragged_overhang_and_dummy_tiles": ((40, 50, 9), TILE),
    # x = 14 < pad 16: the halo is clamped to 14, which still covers the shrink
    "pad_clamp": ((14, 30, 6), TILE),
    "one_tile_batch": ((16, 24, 8), dict(TILE, batch=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_probability_map_matches_jax(nets, case):
    shape, tile = CASES[case]
    got, want = _both(nets, _volume(shape), tile, use_probability_map=True)
    assert got.shape == want.shape == (1, *shape, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_uint8_threshold_matches_jax(nets):
    vol = _volume((40, 50, 9))
    got, want = _both(nets, vol, TILE, use_probability_map=False)
    prob, _ = _both(nets, vol, TILE, use_probability_map=True)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}
    differ = got != want
    assert np.all(np.abs(prob[differ] - 0.5) < 1e-5)


def test_postprocess_epilogue_matches_jax(nets):
    got, want = _both(
        nets, _volume((40, 50, 9)), TILE, use_probability_map=True,
        postprocess=(1.5, 0.45, 10.0),
    )
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got == 0).any() and got.max() > 4.5  # the floor and the scale acted


def test_empty_tiles_and_nan_scrub_match_jax(nets):
    """Tiles whose whole padded window is -1 give zeros; nan/inf scrub to
    (0, 1, 0) before padding."""
    vol = _volume((64, 24, 8))
    vol[:, :40] = -1.0
    vol[0, 50, 3, 2, 1] = np.nan
    vol[0, 51, 4, 3, 2] = np.inf
    vol[0, 52, 5, 4, 3] = -np.inf
    got, want = _both(nets, vol, TILE, use_probability_map=True)
    assert np.all(got[0, :16] == 0)  # the first tile column is empty
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_insufficient_pad_raises_like_jax(nets):
    cfg, jcfg, japply, tapply = nets
    tile = dict(TILE, pad=(8, 8, 2))
    with pytest.raises(ValueError, match="padding is not sufficient"):
        jtiling.predict_segmentation_mask(
            japply, jnp.asarray(_volume((40, 50, 9))), jcfg, JaxTileConfig(**tile)
        )
    with pytest.raises(ValueError, match="padding is not sufficient"):
        ttiling.predict_segmentation_mask(
            tapply, _volume((40, 50, 9)), cfg, TileConfig(**tile), device="cpu"
        )


@pytest.mark.parametrize("prob", [True, False], ids=["probability", "uint8"])
def test_reference_grid_matches_jax(nets, prob):
    """The reference's ragged windows (``calculate_indexes``, one width per
    axis here) need pad >= shrink + 1, hence pad_z 3."""
    cfg, jcfg, japply, tapply = nets
    tile = dict(eval_size=(16, 24, 8), pad=(16, 16, 3), batch=1)
    vol = _volume((40, 24, 9))
    want = jtiling.predict_segmentation_mask_reference_grid(
        japply, jnp.asarray(vol), jcfg, JaxTileConfig(**tile), use_probability_map=prob
    )
    got = ttiling.predict_segmentation_mask_reference_grid(
        tapply, vol, cfg, TileConfig(**tile), use_probability_map=prob, device="cpu"
    )
    assert ttiling.reference_tile_windows(
        (40, 24, 9), (16, 24, 8), (16, 16, 3)
    ) == jtiling.reference_tile_windows((40, 24, 9), (16, 24, 8), (16, 16, 3))
    assert got.dtype == want.dtype and got.shape == want.shape
    if prob:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        p = ttiling.predict_segmentation_mask_reference_grid(
            tapply, vol, cfg, TileConfig(**tile), use_probability_map=True, device="cpu"
        )
        assert np.all(np.abs(p[got != want] - 0.5) < 1e-5)
