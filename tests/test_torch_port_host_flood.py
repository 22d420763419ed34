"""The port's host flood (``hcunet_tpu_torch/ops/watershed.py`` over
``csrc/watershed_host.cpp``, built by g++ with ``native/Makefile``'s flags)
and the instance stage's host backends, against the JAX package's.

The two libraries are one source compiled with the same flags, and the
instance stage's host arithmetic is the same numpy, so every label must be
equal bit for bit.  ``host_ram_bytes`` is passed explicitly so that both
sides pick the same tile geometry and worker cap on any machine.
"""

import dataclasses

import numpy as np
import pytest

from hcunet_tpu.config import WatershedConfig as JaxWatershedConfig
from hcunet_tpu.infer import instance as jinst
from hcunet_tpu.ops import watershed as jws
from hcunet_tpu_torch.config import WatershedConfig
from hcunet_tpu_torch.infer import instance as tinst
from hcunet_tpu_torch.ops import watershed as tws

from test_torch_port_instance import _boxes_on_blobs
from test_watershed_parity import _blob_scene, _instance_scene

GIB = 2**30


def _scene(name):
    """The scenes of ``tests/test_watershed_parity.py``: ``(image, markers,
    mask, kwargs)``."""
    if name == "3d":
        img, markers = _blob_scene(np.random.default_rng(3), (18, 16, 6), n_blobs=3)
        return img, markers, img < -0.05, dict(connectivity=2, compactness=0.01, watershed_line=True)
    if name == "2d":
        img, markers = _blob_scene(np.random.default_rng(101), (28, 24), n_blobs=4)
        return img, markers, None, dict(connectivity=1, compactness=0.01, watershed_line=True)
    if name == "plateaus":
        img, markers = _blob_scene(np.random.default_rng(202), (16, 14, 5), 3, quantize=True)
        return img, markers, img < 0, dict(connectivity=1, compactness=0.01, watershed_line=True)
    if name == "marker_slabs":
        markers = np.zeros((8, 8, 3), np.int32)
        markers[:4], markers[4:] = 1, 2
        return np.zeros((8, 8, 3)), markers, None, dict(compactness=0.0, watershed_line=True)
    img, markers = _blob_scene(np.random.default_rng(42), (20, 20, 4), n_blobs=2)
    return img, markers, None, dict(connectivity=3, compactness=0.0, watershed_line=False)


@pytest.mark.parametrize("name", ["3d", "2d", "plateaus", "marker_slabs", "unmasked"])
def test_watershed_equals_jax(name):
    img, markers, mask, kw = _scene(name)
    got = tws.watershed(img, markers, mask=mask, **kw)
    want = jws.watershed(img, markers, mask=mask, **kw)
    assert got.dtype == np.int32 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 2


def _tile_inputs(seed):
    """The normalized height map, mask and seeds of
    ``test_watershed_parity.py::test_fused_instance_tile_matches_materialized``."""
    rng = np.random.default_rng(seed)
    tile = _instance_scene(rng, (72, 64, 6), 6).astype(np.float64) + 1e-8
    tile -= tile.min()
    tile /= tile.max()
    seeds = np.zeros(tile.shape, np.int32)
    for i in range(4):
        x, y = int(rng.uniform(10, 60)), int(rng.uniform(10, 50))
        seeds[x : x + 2, y : y + 2, 2:4] = i + 2
    return tile, tile > 0.5, seeds


@pytest.mark.parametrize("seed", [0, 1])
def test_instance_tile_and_label_equal_jax(seed):
    tile, binary, seeds = _tile_inputs(seed)
    kw = dict(expand_z=5, expand_mask=3, distance_floor=0.2, seed_background_below=0.15,
              connectivity=1, compactness=0.01, watershed_line=True)
    got = tws.instance_tile(tile, binary, seeds, **kw)
    np.testing.assert_array_equal(got, jws.instance_tile(tile, binary, seeds, **kw))
    assert len(np.unique(got)) >= 3
    for b in (binary, binary[..., 3]):  # 3D and 2D
        labels, n = tws.label(b)
        want, jn = jws.label(b)
        assert n == jn and n >= 1
        np.testing.assert_array_equal(labels, want)


def test_host_flood_rejects_bad_input():
    with pytest.raises(ValueError, match="positive"):
        tws.watershed(np.zeros((4, 4)), -np.ones((4, 4), np.int32))
    with pytest.raises(ValueError, match="shape mismatch"):
        tws.instance_tile(np.zeros((4, 4, 2)), np.zeros((4, 4, 3)), np.zeros((4, 4, 2)),
                          expand_z=2, expand_mask=1, distance_floor=0.2,
                          seed_background_below=0.15)


def _multi_tile_scene(path):
    """A volume two instance tiles wide at the < 16 GB geometry (412 + 2*64),
    with boxes on its blobs: the probability map, or its uint8 mask (the
    binary path, whose height map is the host EDT)."""
    rng = np.random.default_rng(3)
    prob = _instance_scene(rng, (560, 64, 4), 24)
    cand = _boxes_on_blobs(prob, 20, 2)
    return (prob if path == "probability" else (prob > 2.5).astype(np.uint8)), cand


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("backend", ["fused", "materialized"])
@pytest.mark.parametrize("path", ["probability", "binary"])
def test_host_backends_equal_jax(path, backend, workers):
    semantic, cand = _multi_tile_scene(path)
    kw = dict(backend=backend, expand_mask=3, tile_workers=workers)
    want = jinst.generate_unique_segmentation_mask(
        semantic, cand, JaxWatershedConfig(**kw), host_ram_bytes=8 * GIB
    )
    got = tinst.generate_unique_segmentation_mask(
        semantic, cand, WatershedConfig(**kw), host_ram_bytes=8 * GIB
    )
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[0])) - 1 >= 10


@pytest.mark.parametrize("path", ["probability", "binary"])
def test_fused_equals_materialized(path):
    semantic, cand = _multi_tile_scene(path)
    base = WatershedConfig(expand_mask=3, tile_workers=2)
    fused = tinst.generate_unique_segmentation_mask(
        semantic, cand, base, host_ram_bytes=8 * GIB
    )
    mat = tinst.generate_unique_segmentation_mask(
        semantic, cand, dataclasses.replace(base, backend="materialized"), host_ram_bytes=8 * GIB
    )
    np.testing.assert_array_equal(fused[0], mat[0])
    np.testing.assert_array_equal(fused[1], mat[1])


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    """A host library that does not compile raises with g++'s message; the
    port has no fallback flood."""
    from hcunet_tpu_torch.csrc import build, library_path

    src = tmp_path / "broken_flood.cpp"
    src.write_text('extern "C" int f() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed on .*undefined_name"):
        build(str(src), compiler="g++")
    assert not library_path(str(src), compiler="g++").exists()
