"""``Segmenter.predict`` of the port against the JAX package's, on the same
numpy volume and weights, through shape bucketing, the BN-folded forward
and the epilogue.  Tolerances as in ``test_torch_port_tiling.py``."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.infer.serving import Segmenter as JaxSegmenter
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
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


def _host_pad_recipe(seg, vol, bucket):
    """What ``Segmenter.predict`` computed before it padded on the device:
    ``np.pad`` to the bucket with one mode for every axis, the tiled forward
    on the bucket, the map cropped on the host.  Returns the map and the
    mode."""
    spatial = vol.shape[:-1]
    mode = "symmetric" if all(b - s <= s for s, b in zip(spatial, bucket)) else "edge"
    padded = np.pad(vol, [(0, b - s) for s, b in zip(spatial, bucket)] + [(0, 0)], mode=mode)
    out = predict_segmentation_mask(
        seg.apply_fn, np.asarray(padded[None], np.float32), seg.cfg, seg.tile_cfg,
        use_probability_map=seg.use_probability_map, postprocess=seg.postprocess, device="cpu",
    )[0, ..., 0].numpy()
    return out[: spatial[0], : spatial[1], : spatial[2]], mode


# (40, 50, 9) buckets to (48, 72, 16), every pad within its axis; no volume
# reaches a pad wider than its axis through ``bucket_shape`` (a pad is under
# one core, which is under the axis), so the edge case hands the Segmenter a
# deeper bucket, Z 9 -> 24
PAD_CASES = {"symmetric": None, "edge": (48, 72, 24)}


@pytest.mark.parametrize("probability", [True, False], ids=["probability", "mask"])
@pytest.mark.parametrize("mode", sorted(PAD_CASES))
def test_segmenter_device_pad_matches_host_pad(unet, mode, probability, monkeypatch):
    """The pad to the bucket on the device, and the crop there, give the same
    bits as the host ``np.pad`` recipe, in both pad modes, and ``np.pad`` is
    never called."""
    cfg, _, variables = unet
    seg = Segmenter(port_unet(cfg, variables), tile_cfg=TileConfig(**TILE),
                    use_probability_map=probability, device="cpu")
    if PAD_CASES[mode] is not None:
        seg.bucket_shape = lambda spatial: PAD_CASES[mode]
    vol = np.random.default_rng(6).random((40, 50, 9, 4), dtype=np.float32)
    want, want_mode = _host_pad_recipe(seg, vol, seg.bucket_shape(vol.shape[:-1]))
    assert want_mode == mode

    def refuse(*args, **kwargs):
        raise AssertionError("np.pad called")

    monkeypatch.setattr(np, "pad", refuse)
    got = seg.predict(vol)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_segmenter_float64_and_read_only_volumes(unet):
    """A float64 volume gives the bits of its float32 rounding, and a
    read-only one predicts without raising or warning."""
    cfg, _, variables = unet
    seg = Segmenter(port_unet(cfg, variables), tile_cfg=TileConfig(**TILE), device="cpu")
    vol = np.random.default_rng(8).random((40, 50, 9, 4))
    want = seg.predict(vol.astype(np.float32))
    np.testing.assert_array_equal(seg.predict(vol), want)
    frozen = vol.astype(np.float32)
    frozen.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = seg.predict(frozen)
    np.testing.assert_array_equal(got, want)
