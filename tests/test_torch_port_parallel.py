"""Multi-device serving of the PyTorch port (``hcunet_tpu_torch.parallel``,
``Segmenter(mesh=)``, ``ShardedDetect``) against its single-device path and
against the JAX package's mesh path, case for case with
``tests/test_parallel.py``: the port's mesh repeats the CPU 8 times in one
process, JAX's holds the 8 virtual CPU devices.

Tolerances: against the port's single-device engine, exact where the tile
batches are composed alike (the same tile shapes at the same offsets), else
1e-6; against JAX, the serving tests' 1e-5 on probabilities (1e-4 after the
epilogue's ×10 rescale).
"""

import jax
import numpy as np
import pytest
import torch

from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.infer.detect import ShardedDetect as JaxShardedDetect
from hcunet_tpu.infer.serving import Segmenter as JaxSegmenter
from hcunet_tpu.parallel import mesh as jmesh
from hcunet_tpu.parallel.spatial import spatial_sharded_forward as jax_spatial_forward
from hcunet_tpu.parallel.tiled import sharded_tile_config as jax_sharded_tile_config
from hcunet_tpu.parallel.tiled import sharded_tiled_forward as jax_sharded_tiled_forward
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.core.padding import pad_axes
from hcunet_tpu_torch.infer.detect import ShardedDetect
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
from hcunet_tpu_torch.parallel import mesh as pmesh
from hcunet_tpu_torch.parallel.spatial import spatial_sharded_forward
from hcunet_tpu_torch.parallel.tiled import sharded_tile_config, sharded_tiled_forward
from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict
from tests.test_torch_port_detection_train import detector_pair
from tests.torch_port_support import (  # noqa: F401
    SMALL,
    flat,
    jax_unet,
    mesh_pair,
    port_unet,
    spatial8,
)

TILES = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=2)


@pytest.fixture(scope="module")
def unet():
    """``(port config, JAX model, JAX variables, port model)``: the
    two-level net with random weights and statistics."""
    cfg, jmodel, variables = jax_unet(SMALL, (48, 56, 12))
    return cfg, jmodel, variables, port_unet(cfg, variables)


def _jax_apply(unet):
    _cfg, jmodel, variables, _m = unet
    return jax.tree_util.Partial(lambda v, t: jmodel.apply(v, t, train=False), variables)


def _model_forward(model):
    @torch.no_grad()
    def fwd(t):
        return model(t)

    return fwd


def test_port_make_mesh_sizes():
    mesh = pmesh.make_mesh({pmesh.DATA_AXIS: 4, pmesh.MODEL_AXIS: 2}, ["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (4, 2)
    mesh = pmesh.make_mesh({pmesh.DATA_AXIS: -1, pmesh.MODEL_AXIS: 2}, ["cpu"] * 8)
    assert mesh.shape[pmesh.DATA_AXIS] == 4
    assert mesh.axis_devices(pmesh.MODEL_AXIS) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        pmesh.make_mesh({pmesh.DATA_AXIS: 3}, ["cpu"] * 8)
    with pytest.raises(ValueError, match="cannot shard evenly"):
        pmesh.tiles_sharding(mesh, 12)
    assert len(pmesh.tiles_sharding(mesh, 16).devices) == 8
    assert len(pmesh.batch_sharding(mesh).devices) == 4


def test_port_default_mesh_8():
    for n in (8, 4, 2):
        got = pmesh.default_multichip_mesh(n, ["cpu"] * n)
        want = jmesh.default_multichip_mesh(n, jax.devices()[:n])
        assert got.shape == dict(want.shape), n
    assert pmesh.default_multichip_mesh(8, ["cpu"] * 8).shape == {
        "data": 2, "model": 2, "spatial": 2}


@pytest.mark.parametrize("min_size", [8, 32])
def test_port_param_sharding_matches_jax(unet, min_size):
    """``shard_params`` puts on the ``model`` axis the parameters that the
    JAX ``shard_params`` does on the JAX variables (the JAX rule on the JAX
    shapes), splitting torch's dim that is the JAX trailing axis."""
    cfg, _jm, variables, model = unet
    port_mesh, jax_mesh = mesh_pair({"data": 4, "model": 2})
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    split = pmesh.shard_params(
        sd, names, port_mesh, lambda s: jax_variables_from_unet_state_dict(s, cfg), min_size)
    marks = {k: torch.full(v.shape, float(split.get(k) is not None)) for k, v in sd.items()
             if v.is_floating_point()}
    tree = flat(jax_variables_from_unet_state_dict(marks, cfg)["params"])
    assert all(v.min() == v.max() for v in tree.values())
    got = {path for path, v in tree.items() if v.max() == 1}
    shardings = jmesh.shard_params(variables["params"], jax_mesh, min_size=min_size)
    want = {tuple(k.key for k in path)
            for path, s in jax.tree_util.tree_leaves_with_path(shardings)
            if jmesh.MODEL_AXIS in str(s.spec)}
    assert got == want
    assert bool(got) == (min_size == 8)
    for name, d in split.items():
        if d is not None:
            assert d == (1 if name.endswith("up_conv.weight") else 0), name


def test_port_spatial_forward_matches_dense(unet, spatial8):
    """Halo-exchange sharded inference equals the dense forward of the
    symmetrically padded volume, and JAX's ``spatial_sharded_forward``."""
    _cfg, _jm, _v, model = unet
    port_mesh, jax_mesh = spatial8
    halo = (24, 24, 4)
    vol = np.random.default_rng(5).random((1, 192, 48, 8, 4), np.float32)
    slabs = spatial_sharded_forward(_model_forward(model), port_mesh, halo)(torch.from_numpy(vol))
    assert len(slabs) == 8 and all(s.shape == (1, 24, 48, 8, 1) for s in slabs)
    got = pmesh.gather(slabs, "cpu").numpy()

    padded = pad_axes(torch.from_numpy(vol), [(h, h) for h in halo], "symmetric")
    with torch.no_grad():
        dense = torch.sigmoid(model(padded).float())
    dense = dense[:, 24: 192 + 24, 24: 48 + 24, 4: 8 + 4].numpy()
    np.testing.assert_allclose(got, dense, atol=1e-6, rtol=0)

    want = np.asarray(jax_spatial_forward(_jax_apply(unet), jax_mesh, halo)(vol))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("probability", [True, False])
def test_port_sharded_tiled_forward_matches_single_device(unet, spatial8, probability):
    """Each shard's tile grid (two tile columns per slab of 32) equals the
    single-device engine on the same tile geometry, and JAX's
    ``sharded_tiled_forward``; also the thresholded uint8 mask."""
    cfg, _jm, _v, model = unet
    port_mesh, jax_mesh = spatial8
    tiles = TileConfig(**TILES)
    vol = np.random.default_rng(3).random((1, 256, 40, 8, 4), np.float32)
    run = sharded_tiled_forward(_model_forward(model), port_mesh, cfg, tiles,
                                use_probability_map=probability)
    got = run(torch.from_numpy(vol)).numpy()
    single = predict_segmentation_mask(_model_forward(model), vol, cfg, tiles,
                                       use_probability_map=probability, device="cpu").numpy()
    assert got.shape == single.shape == (1, 256, 40, 8, 1)
    assert got.dtype == single.dtype
    np.testing.assert_array_equal(got, single)
    jrun = jax_sharded_tiled_forward(_jax_apply(unet), jax_mesh, cfg, JaxTileConfig(**TILES),
                                     use_probability_map=probability)
    want = np.asarray(jrun(vol))
    if probability:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (got != want).mean() < 1e-4


@pytest.mark.parametrize("case", ["thin_slab", "not_whole_columns", "halo_short"])
def test_port_sharded_tiled_forward_rejects_thin_slab(unet, spatial8, case):
    """The JAX function's three ``ValueError``s: a slab thinner than the
    halo, an X that does not divide into whole tile columns per shard, and
    a halo that does not cover the network's shrink."""
    cfg, _jm, _v, model = unet
    port_mesh, _jax_mesh = spatial8
    tiles, X, match = {
        "thin_slab": (dict(TILES, eval_size=(8, 24, 8)), 64, "thinner than the halo"),
        "not_whole_columns": (TILES, 8 * 16 + 8, "whole 16-wide tile columns"),
        "halo_short": (dict(TILES, pad=(4, 16, 2)), 128, "does not cover"),
    }[case]
    with pytest.raises(ValueError, match=match):
        run = sharded_tiled_forward(_model_forward(model), port_mesh, cfg, TileConfig(**tiles))
        run(torch.zeros((1, X, 40, 8, 4)))


def test_port_sharded_tile_config_divides_slab(unet):
    cfg = unet[0]
    kw = dict(n_shards=8, volume_shape=(320, 64, 8))
    got = sharded_tile_config(cfg, TileConfig(eval_size=(24, 24, 8), pad=(16, 16, 2), batch=2),
                              **kw)
    want = jax_sharded_tile_config(
        cfg, JaxTileConfig(eval_size=(24, 24, 8), pad=(16, 16, 2), batch=2), **kw)
    assert (320 // 8) % got.eval_size[0] == 0
    assert (tuple(got.eval_size), tuple(got.pad), got.batch) == (
        tuple(want.eval_size), tuple(want.pad), want.batch)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_tile_config(cfg, TileConfig(**TILES), n_shards=8, volume_shape=(100, 64, 8))


@pytest.mark.parametrize("case", ["plain", "postprocess_packed"])
def test_port_segmenter_mesh_matches_single_device(unet, spatial8, case, monkeypatch):
    """``Segmenter(mesh=)`` equals the single-device ``Segmenter`` voxel for
    voxel on a volume bucket-padded to the shard quantum (8 × 16), both
    padding on the device (no ``np.pad``), and the JAX ``Segmenter(mesh=)``:
    the model's plain forward, and the packed serving forward with the
    blur/floor/rescale epilogue (run on the gathered volume)."""
    cfg, jmodel, variables, model = unet
    port_mesh, jax_mesh = spatial8
    kw = (dict(packed=False) if case == "plain"
          else dict(postprocess=(3.0, 0.25, 10.0), dtype=torch.float32))
    vol = np.random.default_rng(7).random((128, 40, 8, 4), np.float32)
    seg1 = Segmenter(model, tile_cfg=TileConfig(**TILES), device="cpu", **kw)
    seg8 = Segmenter(model, tile_cfg=TileConfig(**TILES), mesh=port_mesh, **kw)
    assert seg8.device == torch.device("cpu")
    assert seg8.bucket_shape(vol.shape[:-1])[0] % (8 * 16) == 0
    # Y 40 -> 48: both Segmenters pad to the bucket on the device
    assert seg8.bucket_shape(vol.shape[:-1]) == seg1.bucket_shape(vol.shape[:-1]) == (128, 48, 8)
    thin = vol[:100]  # below 8 tile columns: the single-device engine
    assert not seg8._use_sharded(thin.shape[:-1])
    with monkeypatch.context() as m:
        m.setattr(np, "pad", lambda *a, **k: pytest.fail("np.pad called"))
        got = seg8.predict(vol)
        np.testing.assert_array_equal(got, seg1.predict(vol))
        np.testing.assert_array_equal(seg8.predict(thin), seg1.predict(thin))

    jkw = dict(packed=False) if case == "plain" else dict(postprocess=(3.0, 0.25, 10.0))
    jseg = JaxSegmenter(jmodel, variables, JaxTileConfig(**TILES), mesh=jax_mesh, **jkw)
    np.testing.assert_allclose(got, jseg.predict(vol), atol=1e-5 if case == "plain" else 1e-4,
                               rtol=0)


def test_port_segmenter_mesh_needs_a_spatial_axis(unet):
    model = unet[3]
    with pytest.raises(ValueError, match="spatial"):
        Segmenter(model, mesh=pmesh.make_mesh({"data": 2}, ["cpu"] * 2))


def test_port_sharded_detect_honors_swapped_variables(spatial8):
    """``ShardedDetect`` splits the plane batch over the 8 mesh entries
    (zero-padded from 6 to 8) with the per-plane results of the detector
    itself; a different weight tree passed to ``detect`` is loaded once
    (identity-checked) and gives that tree's detections, as in JAX."""
    port_mesh, jax_mesh = spatial8
    jdet, vars_a, det = detector_pair(seed=1)
    _jdet, vars_b, det_b = detector_pair(seed=2)
    x = np.random.default_rng(3).random((6, 64, 64, 3), np.float32)
    base_a, base_b = det.detect(x), det_b.detect(x)
    wrapped = ShardedDetect(det, port_mesh)
    assert wrapped.device == det.device
    got_a = wrapped.detect(x)
    got_b = wrapped.detect(x, vars_b)
    loads = []
    det.load_state_dict = lambda sd: loads.append(sd)
    again = wrapped.detect(x, vars_b)
    assert not loads  # the same tree is not placed again
    for got, base in ((got_a, base_a), (got_b, base_b), (again, base_b)):
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: (8, *v.shape[1:]) for k, v in base.items()}
        np.testing.assert_allclose(got["scores"][:6].numpy(), base["scores"].numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["valid"][:6].numpy(), base["valid"].numpy())
    assert not np.allclose(base_a["scores"].numpy(), base_b["scores"].numpy())

    jwrapped = JaxShardedDetect(jdet, vars_a, jax_mesh)
    xp = np.concatenate([x, np.zeros((2, 64, 64, 3), np.float32)])
    for got, tree in ((got_a, vars_a), (got_b, vars_b)):
        want = jwrapped.detect(tree, xp)
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   atol=1e-5, rtol=0)
