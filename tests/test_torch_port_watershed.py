"""The port's device watershed (``hcunet_tpu_torch/ops/watershed_device.py``)
against its JAX twin ``hcunet_tpu/ops/watershed_jax.py``.

Both run the same float32 relaxation (max, add, compare, select), so the
labels must be equal exactly, on the blob scenes of
``tests/test_watershed_parity.py``, with and without mask, compactness and
watershed lines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.ops.watershed_jax import _shift as jax_shift
from hcunet_tpu.ops.watershed_jax import watershed_jax
from hcunet_tpu_torch.ops.watershed_device import _shift, watershed_device

from test_watershed_parity import _blob_scene


@pytest.mark.parametrize(
    "masked,compactness,line",
    [(True, 0.01, True), (False, 0.0, True), (True, 0.0, False), (False, 0.01, False)],
    ids=["mask_compact_line", "line", "mask", "compact"],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_watershed_device_equals_jax(seed, masked, compactness, line):
    rng = np.random.default_rng(seed)
    img, markers = _blob_scene(rng, (18, 16, 6), n_blobs=3)
    img = img.astype(np.float32)
    mask = img < -0.05 if masked else None
    kw = dict(iters=24, compactness=compactness, watershed_line=line)
    want = np.asarray(watershed_jax(
        jnp.asarray(img), jnp.asarray(markers),
        mask=None if mask is None else jnp.asarray(mask), **kw,
    ))
    got = watershed_device(
        torch.from_numpy(img), torch.from_numpy(markers),
        mask=None if mask is None else torch.from_numpy(mask), **kw,
    ).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2  # the seeds grew into regions


def test_watershed_device_equals_jax_on_plateaus_2d():
    """Quantized heights (large plateaus) and a 2D volume."""
    rng = np.random.default_rng(200)
    img, markers = _blob_scene(rng, (28, 24), n_blobs=4, quantize=True)
    img = img.astype(np.float32)
    kw = dict(iters=40, compactness=0.01, watershed_line=True)
    want = np.asarray(watershed_jax(jnp.asarray(img), jnp.asarray(markers), **kw))
    got = watershed_device(torch.from_numpy(img), torch.from_numpy(markers), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis,direction", [(0, 1), (1, -1), (2, 1), (2, -1)])
def test_shift_equals_jax(axis, direction):
    x = np.random.default_rng(3).random((5, 4, 3)).astype(np.float32)
    want = np.asarray(jax_shift(jnp.asarray(x), axis, direction, 7.0))
    np.testing.assert_array_equal(_shift(torch.from_numpy(x), axis, direction, 7.0).numpy(), want)
