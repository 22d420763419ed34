"""The port's exact EDT (``hcunet_tpu_torch/ops/distance.py``) against the
JAX ``edt``, the TPU Pallas kernel K2 it replaces (in interpret mode) and
scipy.

The min-plus passes add integers below 2^24 and float32(1e12), and each
square and sum is rounded once on both sides, so the port's plain version
must equal both JAX versions exactly; against scipy's float64 EDT the
tolerance is 1e-4.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from hcunet_tpu.ops.distance import edt as jax_edt
from hcunet_tpu_torch.ops.distance import EDT_PASS, edt, edt_per_slice_host, edt_plain

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _binary(shape, seed, p_background=0.35):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) > p_background).astype(np.float32)


@pytest.fixture(scope="module")
def probe():
    """``scripts/probe_edt_device.py``, imported by path (it is a script)."""
    path = os.path.join(REPO_ROOT, "scripts", "probe_edt_device.py")
    spec = importlib.util.spec_from_file_location("probe_edt_device", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (shape, axes): the per-slice layout of the instance stage, a whole-volume
# EDT, one axis only, and a last-axis pass
EDT_CASES = {
    "per_slice": ((20, 37, 3), (0, 1)),
    "all_axes": ((9, 11, 6), None),
    "axis1": ((13, 17, 4), (1,)),
    "last_axis": ((7, 5, 29), (2,)),
}


@pytest.mark.parametrize("case", sorted(EDT_CASES))
def test_edt_plain_equals_jax_edt_exactly(case):
    shape, axes = EDT_CASES[case]
    b = _binary(shape, seed=len(case))
    b[..., 0] = 1  # one slice with no background at all: the 1e12 path
    want = np.asarray(jax_edt(jnp.asarray(b), axes=axes))
    got = edt_plain(torch.from_numpy(b), axes=axes).numpy()
    np.testing.assert_array_equal(got, want)
    # edt on a CPU tensor is the plain version, with no kernel launch
    before = EDT_PASS.launches
    np.testing.assert_array_equal(edt(torch.from_numpy(b), axes=axes).numpy(), want)
    assert EDT_PASS.launches == before


def test_edt_plain_equals_pallas_k2_in_interpret_mode(probe):
    """K2's plain version equals the TPU Pallas kernel (8 x 128 blocks, 1e12
    padding) run in interpret mode, on a shape ragged in both block axes."""
    b = _binary((20, 37, 3), seed=5)
    b[..., 1] = 1
    want = np.asarray(probe.edt_pallas(jnp.asarray(b), axes=(0, 1), interpret=True))
    got = edt_plain(torch.from_numpy(b), axes=(0, 1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(got[..., 1].min()) == 1e6  # no background in the slice


def test_edt_matches_scipy_per_slice():
    b = _binary((31, 24, 4), seed=7)
    want = edt_per_slice_host(b)
    for z in range(b.shape[-1]):
        np.testing.assert_allclose(
            want[..., z], ndi.distance_transform_edt(b[..., z] != 0), atol=1e-6
        )
    got = edt(torch.from_numpy(b), axes=(0, 1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_edt_raises_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="no kernel"):
        edt(torch.zeros((4, 4, 2), device="meta"), axes=(0, 1))
