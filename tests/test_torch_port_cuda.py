"""Kernels K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``), K2
(``csrc/edt_pass.cu``) and K3 (``csrc/dot_blocked.cu``) against their plain
versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; they skip elsewhere.  They import
no JAX, so they also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv3d_valid, conv3d_valid_plain
from hcunet_tpu_torch.ops.distance import EDT_PASS, edt, edt_axis_pass, edt_plain
from hcunet_tpu_torch.ops.dot import DOT_BLOCKED, dot_blocked, dot_blocked_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (x shape, w shape, dilation): ragged M (not a multiple of 128), Cin 4 and
# odd, Cout 1 / 16 / 24 / 64 / 80 (ragged N tiles), K tails, 1x1 kernels.
CASES = [
    ((2, 11, 9, 7, 4), (3, 3, 2, 4, 16), 1),
    ((1, 13, 10, 6, 5), (3, 3, 1, 5, 24), 1),
    ((3, 9, 9, 4, 16), (1, 1, 1, 16, 1), 1),
    ((1, 12, 12, 5, 32), (3, 3, 2, 32, 64), 1),
    ((2, 10, 11, 6, 40), (3, 2, 2, 40, 80), 1),
    ((1, 14, 13, 9, 8), (3, 3, 2, 8, 16), 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_conv3d_valid_matches_plain(cuda, case, dtype):
    xs, ws, dil = CASES[case]
    rng = np.random.default_rng(case)
    k = int(np.prod(ws[:4]))
    x = torch.from_numpy(rng.standard_normal(xs, np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal(ws, np.float32) / np.sqrt(k))
    w = w.to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(ws[-1:], np.float32)).to(cuda)
    for relu in (False, True):
        before = CONV3D_VALID.launches
        got = conv3d_valid(x, w, b, relu, dil)
        torch.cuda.synchronize()
        assert CONV3D_VALID.launches == before + 1
        want = conv3d_valid_plain(x, w, b, relu, dil)
        assert got.shape == want.shape and got.dtype == dtype
        scale = max(1.0, float(want.float().abs().max()))
        # float32: both sum in float32, in different orders.  bfloat16: both
        # round the float32 sum once, so they differ by at most one bf16 ulp
        # (2^-7 relative) where the sums straddle a rounding boundary.
        tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (case, relu, err, tol)


def test_conv3d_valid_rejects_mixed_dtypes(cuda):
    x = torch.zeros((1, 4, 4, 4, 4), device=cuda)
    w = torch.zeros((3, 3, 2, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv3d_valid(x, w)


# (shape, axes): n = 1; n not a multiple of the 128-wide j block; n above
# the 512-long staged k segment; rows not a multiple of the 16-row block;
# axis 0 (rows strided in memory), axis 1 and the last axis (contiguous rows)
EDT_CASES = [
    ((1, 9, 3), (0, 1)),
    ((37, 20, 3), (0, 1)),
    ((700, 45, 2), (0, 1)),
    ((33, 1100, 5), (1,)),
    ((19, 23, 131), (2,)),
    ((129, 300), None),
]


@pytest.mark.parametrize("case", range(len(EDT_CASES)))
def test_edt_pass_equals_plain_exactly(cuda, case):
    shape, axes = EDT_CASES[case]
    rng = np.random.default_rng(case)
    b = torch.from_numpy(rng.random(shape) > 0.3).to(cuda)
    n_axes = len(shape) if axes is None else len(axes)
    before = EDT_PASS.launches
    got = edt(b, axes=axes)
    torch.cuda.synchronize()
    assert EDT_PASS.launches == before + n_axes
    want = edt_plain(b, axes=axes)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())


def test_edt_all_foreground_slice_is_1e6(cuda):
    b = torch.ones((50, 600, 3), dtype=torch.bool, device=cuda)
    b[:, :, 1] = False
    got = edt(b, axes=(0, 1))
    assert torch.equal(got[..., 0], torch.full_like(got[..., 0], 1e6))
    assert float(got[..., 1].abs().max()) == 0.0
    assert torch.equal(got, edt_plain(b, axes=(0, 1)))


def test_edt_axis_pass_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        edt_axis_pass(torch.zeros((4, 4), device=cuda, dtype=torch.float64), 0)
    with pytest.raises(ValueError):
        edt_axis_pass(torch.zeros((4, 6), device=cuda).t(), 0)


# (x shape, N): M, N and K ragged against the 128 x {16, 32, 64} x 32
# tiles; K not a multiple of 16; a single row; N = 1; M over one block row
DOT_CASES = [
    ((1, 1, 1, 13), 5),
    ((2, 7, 9, 72), 16),
    ((1, 11, 13, 40), 33),
    ((3, 17, 5, 130), 70),
    ((1, 300, 3, 24), 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(DOT_CASES)))
def test_dot_blocked_matches_plain(cuda, case, dtype):
    xs, n = DOT_CASES[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal(xs, np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((xs[-1], n), np.float32) / np.sqrt(xs[-1]))
    w = w.to(cuda, dtype)
    before = DOT_BLOCKED.launches
    got = dot_blocked(x, w)
    torch.cuda.synchronize()
    assert DOT_BLOCKED.launches == before + 1
    want = dot_blocked_plain(x, w)
    assert got.shape == want.shape == (*xs[:-1], n) and got.dtype == dtype
    scale = max(1.0, float(want.float().abs().max()))
    # as for K1: float32 sums in other orders; bf16 rounds the float32 sum once
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (case, err, tol)


def test_dot_blocked_raises_on_mixed_devices_and_types(cuda):
    x = torch.zeros((1, 2, 3, 4), device=cuda)
    before = DOT_BLOCKED.launches
    with pytest.raises(ValueError, match="w on"):
        dot_blocked(x, torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="w on"):
        dot_blocked(x.cpu(), torch.zeros((4, 2), device=cuda))
    with pytest.raises(TypeError):
        dot_blocked(x, torch.zeros((4, 2), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        dot_blocked(x, torch.zeros((2, 4), device=cuda).t())
    assert DOT_BLOCKED.launches == before
