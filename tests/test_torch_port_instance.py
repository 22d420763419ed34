"""The port's instance stage (``hcunet_tpu_torch/infer/instance.py``,
``backend="device"`` on the CPU) against the JAX package's, on the scenes
of ``tests/test_watershed_parity.py``.

Seeds are host numpy on both sides and the tile program is the same float32
arithmetic (the EDT exactly so, ``test_torch_port_distance.py``), so labels
and seeds must be equal exactly.  ``host_ram_bytes`` is passed explicitly so
that both sides pick the same tile geometry on any machine.
"""

import numpy as np
import pytest
import torch

from hcunet_tpu.config import WatershedConfig as JaxWatershedConfig
from hcunet_tpu.infer import instance as jinst
from hcunet_tpu_torch.config import WatershedConfig
from hcunet_tpu_torch.infer import instance as tinst
from hcunet_tpu_torch.ops.distance import EDT_PASS

from test_watershed_parity import _instance_scene

GIB = 2**30


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tiles are small, and the test workers share the
    machine's cores (more threads only wait on each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes_on_blobs(prob, n, z):
    """Boxes centred on the blobs: maxima of the max-projection."""
    proj = prob.max(2).copy()
    boxes = []
    for _ in range(n):
        x, y = np.unravel_index(np.argmax(proj), proj.shape)
        boxes.append([x - 8, y - 8, x + 8, y + 8])
        proj[max(0, x - 10): x + 10, max(0, y - 10): y + 10] = 0
    return {
        "boxes": np.asarray(boxes, np.float32),
        "scores": np.full(n, 0.9, np.float32),
        "labels": np.ones(n, np.int32),
        "z_level": np.full(n, float(z), np.float32),
    }


def _both(semantic, cand, ram, **cfg):
    want = jinst.generate_unique_segmentation_mask(
        semantic, cand, JaxWatershedConfig(backend="device", **cfg), host_ram_bytes=ram
    )
    got = tinst.generate_unique_segmentation_mask(
        semantic, cand, WatershedConfig(backend="device", **cfg), host_ram_bytes=ram,
        device="cpu",
    )
    return got, want


@pytest.mark.parametrize("scene", ["probability", "binary"])
def test_device_backend_equals_jax(scene):
    """The scenes of ``test_watershed_parity.py:264-337``: a probability map
    (normalized height map) and its uint8 mask (per-slice EDT height map)."""
    rng = np.random.default_rng(11 if scene == "probability" else 7)
    prob = _instance_scene(rng, (96, 96, 6), 5)
    cand = _boxes_on_blobs(prob, 5, 3)
    semantic = prob if scene == "probability" else (prob > 2.5).astype(np.uint8)
    before = EDT_PASS.launches
    (labels, seeds), (jl, js) = _both(semantic, cand, 32 * GIB)
    assert EDT_PASS.launches == before  # the CPU runs the plain EDT
    np.testing.assert_array_equal(seeds, js)
    np.testing.assert_array_equal(labels, jl)
    assert labels.dtype == seeds.dtype == np.int32
    assert len(np.unique(labels)) - 1 >= 4


def test_device_backend_equals_jax_across_tiles():
    """A volume wider than one 412 + 2*64 tile (the < 16 GB geometry), so
    two overlapping tiles are flooded and merged with their edge labels
    suppressed."""
    rng = np.random.default_rng(3)
    prob = _instance_scene(rng, (560, 64, 4), 24)
    cand = _boxes_on_blobs(prob, 20, 2)
    semantic = (prob > 2.5).astype(np.uint8)
    (labels, seeds), (jl, js) = _both(
        semantic, cand, 8 * GIB, expand_mask=3, device_iters=32
    )
    np.testing.assert_array_equal(seeds, js)
    np.testing.assert_array_equal(labels, jl)
    assert len(np.unique(labels)) - 1 >= 10


@pytest.mark.parametrize("ram_gib", [8, 64])
@pytest.mark.parametrize("spatial", [(2304, 2304), (300, 1400), (96, 96)])
def test_tile_geometry_and_worker_cap_equal_jax(spatial, ram_gib):
    ram = ram_gib * GIB
    pad, ev = tinst._instance_tile_geometry(spatial, ram)
    assert (pad, ev) == jinst._instance_tile_geometry(spatial, ram)
    for backend in ("device", "materialized"):
        got = tinst._cap_tile_workers(
            64, pad, ev, 15, WatershedConfig(backend=backend), ram, 2
        )
        want = jinst._cap_tile_workers(
            64, pad, ev, 15, JaxWatershedConfig(backend=backend), ram, 2
        )
        assert got == want


def test_empty_candidates_give_empty_volumes():
    labels, seeds = tinst.generate_unique_segmentation_mask(
        np.zeros((8, 8, 2), np.uint8), {"boxes": np.zeros((0, 4)), "scores": []},
        WatershedConfig(backend="device"), device="cpu",
    )
    assert labels.shape == seeds.shape == (8, 8, 2) and not labels.any()


@pytest.mark.parametrize("name", ["DetectorConfig", "WatershedConfig"])
def test_slice2_configs_equal_jax(name):
    """The port's copies of the two configs: the same fields and defaults."""
    import dataclasses

    import hcunet_tpu.config as jcfg
    import hcunet_tpu_torch.config as tcfg

    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())
