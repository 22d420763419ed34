"""Kernels K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``, also as the input
gradient of a conv), K2 (``csrc/edt_pass.cu``) and K3
(``csrc/dot_blocked.cu``) against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; they skip elsewhere.  They import
no JAX, so they also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.csrc import build
from hcunet_tpu_torch.ops.conv import (
    CONV3D_ROUTES,
    CONV3D_VALID,
    CONV3D_VALID_INPUT_GRAD,
    conv3d_valid,
    conv3d_valid_input_grad,
    conv3d_valid_input_grad_plain,
    conv3d_valid_plain,
    conv3d_valid_route,
    conv_valid,
)
from hcunet_tpu_torch.ops.distance import (
    EDT_PASS,
    _axis_pass_plain,
    edt,
    edt_axis_pass,
    edt_plain,
)
from hcunet_tpu_torch.ops.dot import (
    DOT_BLOCKED,
    DOT_ROUTES,
    dot_blocked,
    dot_blocked_plain,
    dot_blocked_route,
)

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
    route = conv3d_valid_route(dtype, xs[-1], ws[-1])
    for relu in (False, True):
        before = CONV3D_VALID.launches
        before_route = CONV3D_VALID.route_launches[route]
        got = conv3d_valid(x, w, b, relu, dil)
        torch.cuda.synchronize()
        assert CONV3D_VALID.launches == before + 1
        assert CONV3D_VALID.route_launches[route] == before_route + 1
        want = conv3d_valid_plain(x, w, b, relu, dil)
        assert got.shape == want.shape and got.dtype == dtype
        scale = max(1.0, float(want.float().abs().max()))
        # float32: both sum in float32, in different orders.  bfloat16: both
        # round the float32 sum once, so they differ by at most one bf16 ulp
        # (2^-7 relative) where the sums straddle a rounding boundary.
        tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (case, relu, err, tol)


# K1's ring path (bfloat16, Cin % 8 == 0): Cin 8 to 128, Cout 1 (weights
# copied element by element) to 200 (ragged N tiles at 24, 80, 130, 136 and
# 200; two 128-wide N tiles from 130 up, 130 with its weights copied
# element by element), K tails (Cin 24: K = 432, not a multiple of the
# 64-deep stage), K = 2304, dilation 2, M never a multiple of the 128-row
# block.
RING_CASES = [
    ((1, 14, 13, 9, 8), (3, 3, 2, 8, 16), 1),
    ((2, 11, 9, 7, 16), (3, 3, 2, 16, 1), 1),
    ((3, 9, 9, 4, 16), (1, 1, 1, 16, 1), 1),
    ((2, 10, 11, 6, 24), (3, 3, 2, 24, 24), 1),
    ((1, 12, 12, 5, 32), (3, 3, 2, 32, 64), 1),
    ((2, 10, 9, 6, 64), (3, 3, 2, 64, 80), 1),
    ((1, 10, 9, 6, 128), (3, 3, 2, 128, 128), 1),
    ((1, 9, 8, 7, 128), (3, 3, 2, 128, 64), 1),
    ((1, 13, 12, 9, 16), (3, 3, 2, 16, 16), 2),
    ((2, 12, 10, 8, 32), (3, 3, 2, 32, 16), 2),
    ((1, 9, 10, 6, 16), (3, 3, 2, 16, 200), 1),
    ((2, 8, 9, 7, 32), (3, 3, 2, 32, 136), 2),
    ((1, 10, 9, 5, 24), (3, 3, 1, 24, 130), 1),
]


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_conv3d_valid_ring_path_matches_plain(cuda, case):
    xs, ws, dil = RING_CASES[case]
    rng = np.random.default_rng(100 + case)
    k = int(np.prod(ws[:4]))
    x = torch.from_numpy(rng.standard_normal(xs, np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(ws, np.float32) / np.sqrt(k))
    w = w.to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(ws[-1:], np.float32)).to(cuda)
    assert conv3d_valid_route(torch.bfloat16, xs[-1], ws[-1]) == "ring"
    for relu in (False, True):
        before = dict(CONV3D_VALID.route_launches)
        got = conv3d_valid(x, w, b, relu, dil)
        torch.cuda.synchronize()
        assert CONV3D_VALID.route_launches == {**before, "ring": before["ring"] + 1}
        want = conv3d_valid_plain(x, w, b, relu, dil)
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        # as above: one bf16 rounding of a float32 sum on each side
        tol = 2.0**-7 * max(1.0, float(want.float().abs().max()))
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (case, relu, err, tol)


# K1's input gradient at the training shapes: (kernel, Cin, Cout) of the
# production U-Net's 14 layers whose input needs a gradient (dense weights,
# groups = 2 as block-diagonal), at a small output gradient; the bf16 ones
# take the ring path (Cin' = Cout, 16 to 128) but out_conv's (Cin' = 1)
TRAIN_LAYERS = [
    ((3, 3, 1), 16, 16), ((3, 3, 2), 16, 32), ((3, 3, 1), 32, 32), ((3, 3, 2), 32, 64),
    ((3, 3, 1), 64, 64), ((3, 3, 2), 64, 128), ((3, 3, 1), 128, 128),
    ((3, 3, 2), 128, 64), ((3, 3, 1), 64, 64), ((3, 3, 2), 64, 32), ((3, 3, 1), 32, 32),
    ((3, 3, 2), 32, 16), ((3, 3, 1), 16, 16), ((1, 1, 1), 16, 1),
]


# The subpixel route of the transposed convs (compile_serving_apply(
# subpixel_tconv=True)): one K1 launch per up level with the four parity
# kernels stacked along Cout, on x zero-padded by (3, 3, 1).  The padded x
# and stacked weights at the three up levels of a production_3d (156, 156,
# 10) tile: Cin 128 / 64 / 32, stacked Cout 256 / 128 / 64.
SUBPIXEL_CASES = [
    ((1, 18, 18, 8, 128), (4, 4, 2, 128, 256)),
    ((1, 32, 32, 8, 64), (4, 4, 2, 64, 128)),
    ((2, 60, 60, 8, 32), (4, 4, 2, 32, 64)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(SUBPIXEL_CASES)), ids=["up0", "up1", "up2"])
def test_conv3d_valid_subpixel_parity_convs_match_plain(cuda, case, dtype):
    from hcunet_tpu_torch.infer.compile import subpixel_tconv_weights, tconv_subpixel

    xs, ws = SUBPIXEL_CASES[case]
    rng = np.random.default_rng(100 + case)
    cin, cout = xs[-1], ws[-1] // 4
    x = torch.from_numpy(rng.standard_normal((xs[0], xs[1] - 6, xs[2] - 6, xs[3] - 2, cin),
                                             np.float32)).to(cuda, dtype)
    w_up = torch.from_numpy(rng.standard_normal((8, 8, 2, cin, cout), np.float32))
    w_sub = (subpixel_tconv_weights(w_up) / np.sqrt(4 * 4 * 2 * cin)).to(cuda, dtype)
    assert tuple(w_sub.shape) == ws
    b = torch.from_numpy(rng.standard_normal(cout, np.float32)).to(cuda).repeat(4)
    route = conv3d_valid_route(dtype, cin, ws[-1])
    assert route == ("ring" if dtype == torch.bfloat16 else "basic")
    before = dict(CONV3D_VALID.route_launches)
    got = tconv_subpixel(x, w_sub, b)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in CONV3D_VALID.route_launches.items()} == {
        r: int(r == route) for r in CONV3D_ROUTES}
    want = tconv_subpixel(x, w_sub, b, conv3d_valid_plain)
    assert got.shape == want.shape == (xs[0], 2 * xs[1] - 6, 2 * xs[2] - 6, xs[3] - 1, cout)
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (case, err, tol)


# The recurrent family's same-padding convs (conv_same: a zero pad, then
# K1), (x shape, w shape, padding, dilation) at small sizes: the
# RecursiveUNet's first conv (Cin 9: the basic path), a 3x3x3 at Cin 32
# (the ring path in bf16), its 1x1x1 out conv (Cout 5), RDCNet's squeeze
# (Cin 20), its five dilated 5^3 convs (Cin 10) and its merge (Cin 50)
SAME_CASES = [
    ((1, 12, 10, 6, 9), (3, 3, 3, 9, 16), 1, 1),
    ((2, 8, 9, 6, 32), (3, 3, 3, 32, 32), 1, 1),
    ((1, 10, 9, 6, 16), (1, 1, 1, 16, 5), 0, 1),
    ((1, 12, 11, 5, 20), (1, 1, 1, 20, 10), 0, 1),
    *[((1, 12, 11, 5, 10), (5, 5, 5, 10, 10), 2 * d, d) for d in range(1, 6)],
    ((1, 12, 11, 5, 50), (1, 1, 1, 50, 10), 0, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(SAME_CASES)))
def test_conv_same_through_k1_matches_plain(cuda, case, dtype):
    from hcunet_tpu_torch.ops.conv import conv_same

    xs, ws, pad, dil = SAME_CASES[case]
    rng = np.random.default_rng(200 + case)
    x = torch.from_numpy(rng.standard_normal(xs, np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal(ws, np.float32) / np.sqrt(np.prod(ws[:4])))
    w = w.to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(ws[-1:], np.float32)).to(cuda)
    route = conv3d_valid_route(dtype, xs[-1], ws[-1])
    before = dict(CONV3D_VALID.route_launches)
    got = conv_same(x, w, b, padding=pad, dilation=dil, relu=True, accum_dtype=dtype)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in CONV3D_VALID.route_launches.items()} == {
        r: int(r == route) for r in CONV3D_ROUTES}
    want = conv_same(x, w, b, padding=pad, dilation=dil, relu=True, accum_dtype=dtype,
                     conv=conv3d_valid_plain)
    assert got.shape == want.shape == (*xs[:4], ws[-1]) and got.dtype == dtype
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (case, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(64, 32), (32, 16)], ids=["gate", "up2"])
def test_recurrent_parity_conv_pad2_matches_plain(cuda, cin, cout, dtype):
    """The RecursiveUNet's (6, 6, 5)/(2, 2, 1) transposed conv with padding 2
    by the subpixel route: one K1 launch of the (3, 3, 5) stacked parity
    kernels on x padded by (1, 1, 2), against the same route on the plain
    conv."""
    from hcunet_tpu_torch.infer.compile import subpixel_tconv_weights, tconv_subpixel

    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((2, 16, 14, 10, cin), np.float32)).to(cuda, dtype)
    w_up = torch.from_numpy(rng.standard_normal((6, 6, 5, cin, cout), np.float32))
    w_sub = (subpixel_tconv_weights(w_up) / np.sqrt(9 * 5 * cin)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(cout, np.float32)).to(cuda).repeat(4)
    before = CONV3D_VALID.launches
    got = tconv_subpixel(x, w_sub, b, pad=2)
    torch.cuda.synchronize()
    assert CONV3D_VALID.launches == before + 1
    want = tconv_subpixel(x, w_sub, b, conv3d_valid_plain, pad=2)
    assert got.shape == want.shape == (2, 32, 28, 10, cout)
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_recurrent_serving_launches_per_step(cuda, family):
    """One step of each recurrent serving forward on the card: the
    RecursiveUNet launches K1 20 times a timestep (in bf16 19 on the ring
    path, the 9-channel first conv on the basic one), RDCNet 7 times an
    iteration and once for its output conv, all on the basic path; and the
    float32 K1 forward is within 1e-4 of the output's scale of the one built
    on the plain conv (each conv differs by float32 summation order, and a
    step chains 9 convs deep)."""
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet

    torch.manual_seed(0)
    if family == "runet":
        model, spatial = RecursiveUNet(RUNetConfig(timesteps=1)).eval(), (32, 32, 6)
        want_bf16 = {"basic": 1, "ring": 19}
    else:
        model, spatial = RDCNet(RDCNetConfig(timesteps=1)).eval(), (32, 32, 10)
        want_bf16 = {"basic": 8, "ring": 0}
    x = torch.randn((1, *spatial, 4), device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        apply = compile_recurrent_apply(model, dtype=dtype, device=cuda)
        before = dict(CONV3D_VALID.route_launches)
        got = apply(x)
        torch.cuda.synchronize()
        n = sum(want_bf16.values())
        want_routes = want_bf16 if dtype == torch.bfloat16 else {"basic": n, "ring": 0}
        assert {r: c - before[r] for r, c in CONV3D_VALID.route_launches.items()} == want_routes
    plain = compile_recurrent_apply(model, dtype=torch.float32, device=cuda,
                                    conv=conv3d_valid_plain)(x)
    gap = float((got - plain).abs().max() / plain.abs().max())
    assert gap <= 1e-4, gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layer", range(len(TRAIN_LAYERS)))
def test_conv3d_valid_input_grad_matches_plain(cuda, layer, dtype):
    """K1 computing a conv's input gradient (the padded output gradient
    with the flipped kernel), against the plain version, on the path named
    for Cin' = Cout, at K1's usual tolerances."""
    k, cin, cout = TRAIN_LAYERS[layer]
    rng = np.random.default_rng(300 + layer)
    gy = torch.from_numpy(rng.standard_normal((2, 13, 11, 6, cout), np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((*k, cin, cout), np.float32) / np.sqrt(np.prod(k) * cin))
    w = w.to(cuda, dtype)
    route = conv3d_valid_route(dtype, cout, cin)
    assert route == ("ring" if dtype == torch.bfloat16 and cout % 8 == 0 else "basic")
    before = dict(CONV3D_VALID_INPUT_GRAD.route_launches)
    got = conv3d_valid_input_grad(gy, w)
    torch.cuda.synchronize()
    assert CONV3D_VALID_INPUT_GRAD.route_launches == {**before, route: before[route] + 1}
    want = conv3d_valid_input_grad_plain(gy, w)
    assert got.shape == want.shape == (2, 13 + k[0] - 1, 11 + k[1] - 1, 6 + k[2] - 1, cin)
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol


# K1's input gradient at the recurrent family's training shapes
# (conv_same: the gradient of the zero-padded input), (kernel, dilation,
# Cin, Cout): the RecursiveUNet's 3^3 convs (Cin 9-64) and 1^3 out conv,
# RDCNet's squeeze, its five dilated 5^3 convs, its merge and its 3^3
# output conv; bf16 takes the ring path where Cout % 8 == 0
RECURRENT_GRADS = [
    (3, 1, 9, 16), (3, 1, 16, 16), (3, 1, 16, 32), (3, 1, 32, 32), (3, 1, 32, 64),
    (3, 1, 64, 64), (3, 1, 64, 32), (3, 1, 32, 16), (1, 1, 16, 5),
    (1, 1, 20, 10), *[(5, d, 10, 10) for d in range(1, 6)], (1, 1, 50, 10), (3, 1, 10, 10),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(RECURRENT_GRADS)),
                         ids=[f"k{k}d{d}c{ci}-{co}" for k, d, ci, co in RECURRENT_GRADS])
def test_conv3d_valid_input_grad_recurrent_shapes_match_plain(cuda, case, dtype):
    """K1 as the input gradient of a same-padding conv (the output gradient
    padded by d (k - 1), the flipped kernel), against the plain version, at
    K1's usual tolerances, on the path named for Cin' = Cout."""
    k, d, cin, cout = RECURRENT_GRADS[case]
    rng = np.random.default_rng(400 + case)
    gy = torch.from_numpy(rng.standard_normal((1, 12, 11, 6, cout), np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((k, k, k, cin, cout), np.float32) / np.sqrt(k**3 * cin))
    w = w.to(cuda, dtype)
    route = conv3d_valid_route(dtype, cout, cin)
    before = dict(CONV3D_VALID_INPUT_GRAD.route_launches)
    got = conv3d_valid_input_grad(gy, w, d)
    torch.cuda.synchronize()
    assert CONV3D_VALID_INPUT_GRAD.route_launches == {**before, route: before[route] + 1}
    want = conv3d_valid_input_grad_plain(gy, w, d)
    assert got.shape == want.shape == (1, *(n + d * (k - 1) for n in (12, 11, 6)), cin)
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dilation", [1, 5])
def test_conv_same_gradient_goes_through_k1(cuda, dilation):
    """A same-padding conv that needs a gradient runs K1 forward and K1 for
    its input gradient, and its gradients (x, w, b) match plain autograd
    through the plain version (TF32 off) within 1e-5 of their scale."""
    from hcunet_tpu_torch.ops.conv import conv_same

    rng = np.random.default_rng(dilation)
    x0 = torch.from_numpy(rng.standard_normal((1, 12, 11, 6, 10), np.float32)).to(cuda)
    w0 = torch.from_numpy(rng.standard_normal((5, 5, 5, 10, 10), np.float32) / 35).to(cuda)
    b0 = torch.from_numpy(rng.standard_normal(10, np.float32)).to(cuda)
    r = torch.from_numpy(rng.standard_normal((1, 12, 11, 6, 10), np.float32)).to(cuda)
    grads = []
    for conv in (conv3d_valid, conv3d_valid_plain):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        fwd, grad = CONV3D_VALID.launches, CONV3D_VALID_INPUT_GRAD.launches
        out = conv_same(x, w, b, padding=2 * dilation, dilation=dilation, relu=True, conv=conv)
        (out * r).sum().backward()
        torch.cuda.synchronize()
        assert (CONV3D_VALID.launches - fwd, CONV3D_VALID_INPUT_GRAD.launches - grad) == (
            (1, 1) if conv is conv3d_valid else (0, 0))
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_recurrent_training_step_launches(cuda, family):
    """One ``RecurrentTrainer`` step of one timestep on the card: the
    RecursiveUNet launches K1 17 times forward (its transposed convs are
    cuDNN's) and 16 times for input gradients (none for the first conv of
    timestep 0), RDCNet 8 and 8, all on the basic path in float32; the
    loss is finite."""
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig

    torch.manual_seed(0)
    if family == "runet":
        model, want = RecursiveUNet(RUNetConfig(timesteps=1)), (17, 16)
    else:
        model, want = RDCNet(RDCNetConfig(timesteps=1)), (8, 8)
    trainer = RecurrentTrainer(model, cfg=TrainConfig(log_every=0), device=cuda)
    x = torch.randn((1, 32, 32, 6, 4), device=cuda)
    mask = (torch.rand((1, 32, 32, 6, 1), device=cuda) > 0.5).float()
    vec = torch.randn((1, 32, 32, 6, 3), device=cuda)
    fwd, grad = dict(CONV3D_VALID.route_launches), dict(CONV3D_VALID_INPUT_GRAD.route_launches)
    loss = trainer.train_step(x, mask, torch.ones_like(mask), vec)
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert {r: n - fwd[r] for r, n in CONV3D_VALID.route_launches.items()} == {
        "basic": want[0], "ring": 0}
    assert {r: n - grad[r] for r, n in CONV3D_VALID_INPUT_GRAD.route_launches.items()} == {
        "basic": want[1], "ring": 0}


@pytest.mark.parametrize("groups", [1, 2])
def test_conv_gradient_goes_through_k1(cuda, groups):
    """On the card a conv whose weight needs a gradient runs K1 forward and
    K1 for the input gradient (none where the input needs none), and its
    gradients match plain autograd through the plain version (TF32 off);
    with a bias or ReLU it raises rather than return an output without a
    gradient."""
    rng = np.random.default_rng(groups)
    x0 = torch.from_numpy(rng.standard_normal((2, 12, 11, 7, 16), np.float32)).to(cuda)
    w0 = torch.from_numpy(rng.standard_normal((3, 3, 2, 16 // groups, 32), np.float32) / 12).to(cuda)
    r = torch.from_numpy(rng.standard_normal((2, 10, 9, 6, 32), np.float32)).to(cuda)
    grads = []
    for kernel in (True, False):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        fwd, grad = CONV3D_VALID.launches, CONV3D_VALID_INPUT_GRAD.launches
        if kernel:
            out = conv_valid(x, w, groups=groups)
        else:
            from hcunet_tpu_torch.ops.conv import block_diagonal_weights

            wd = block_diagonal_weights(w, groups) if groups > 1 else w
            out = conv3d_valid_plain(x, wd)
        (out * r).sum().backward()
        torch.cuda.synchronize()
        assert (CONV3D_VALID.launches - fwd, CONV3D_VALID_INPUT_GRAD.launches - grad) == (
            (1, 1) if kernel else (0, 0))
        grads.append((x.grad, w.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    w = w0.clone().requires_grad_()
    before = CONV3D_VALID_INPUT_GRAD.launches
    conv_valid(x0, w, groups=groups).sum().backward()  # x0 needs no gradient
    assert CONV3D_VALID_INPUT_GRAD.launches == before
    wd = torch.zeros((3, 3, 2, 16, 32), device=cuda, requires_grad=True)
    for kw in (dict(bias=torch.zeros(32, device=cuda)), dict(relu=True)):
        with pytest.raises(ValueError, match="gradient path"):
            conv3d_valid(x0, wd, **kw)


def test_conv3d_valid_route_is_the_c_entry_points(cuda):
    """The C entry point decides the path; the Python rule, which the
    wrapper counts launches by, names the same one."""
    path, _ = build(CONV3D_VALID.source)
    route = ctypes.CDLL(str(path)).conv3d_valid_route
    route.argtypes, route.restype = [ctypes.c_int] * 3, ctypes.c_int
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for cin in range(1, 137):
            for cout in (1, 16, 24, 64, 80, 128):
                assert CONV3D_ROUTES[route(code, cin, cout)] == conv3d_valid_route(dtype, cin, cout)


def test_conv3d_valid_ring_path_rejects_misaligned_input(cuda):
    """The ring copies 16 bytes at a time: an input that does not start on
    a 16-byte boundary is copied once to an aligned allocation and still
    takes the ring path, with the plain version's result."""
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.standard_normal(2 * 6 * 6 * 4 * 16 + 1, np.float32))
    x = base.to(cuda, torch.bfloat16)[1:].view(2, 6, 6, 4, 16)
    w = torch.from_numpy(rng.standard_normal((3, 3, 2, 16, 16), np.float32) / 17)
    w = w.to(cuda, torch.bfloat16)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    before = dict(CONV3D_VALID.route_launches)
    got = conv3d_valid(x, w, None, True)
    torch.cuda.synchronize()
    assert CONV3D_VALID.route_launches == {**before, "ring": before["ring"] + 1}
    want = conv3d_valid_plain(x, w, None, True)
    tol = 2.0**-7 * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
    # a misaligned w as well
    wm = torch.empty(w.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(w.shape)
    wm.copy_(w)
    assert wm.data_ptr() % 16 != 0
    got = conv3d_valid(x, wm, None, True)
    torch.cuda.synchronize()
    assert CONV3D_VALID.route_launches == {**before, "ring": before["ring"] + 2}
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_conv3d_valid_rejects_mixed_dtypes(cuda):
    x = torch.zeros((1, 4, 4, 4, 4), device=cuda)
    w = torch.zeros((3, 3, 2, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv3d_valid(x, w)


# (shape, axes, mask, ulps): the mask's kind (_edt_mask) and the stated
# tolerance.  Random masks with n not a multiple of 32, rows not a multiple
# of the 32-row block, axis 0 (rows strided in memory), axis 1 and the last
# axis (inner == 1, contiguous rows); n = 1 and n = 2; a single zero at
# each end of a row; all background; one zero per slice and sparse zeros
# (distances run to about n, the stacks stay short); n = 4097, where
# 4096^2 = 2^24 is still exact, and n = 6000, where the squares round:
# K2's stated bound above n = 4096 is 2 ulps (0 measured).
EDT_CASES = [
    ((1, 9, 3), (0, 1), "random", 0),
    ((37, 20, 3), (0, 1), "random", 0),
    ((700, 45, 2), (0, 1), "random", 0),
    ((33, 1100, 5), (1,), "random", 0),
    ((19, 23, 131), (2,), "random", 0),
    ((129, 300), None, "random", 0),
    ((1, 1, 4), (0, 1), "random", 0),
    ((2, 2, 5), (0, 1), "random", 0),
    ((40, 30, 3), (0, 1), "ends", 0),
    ((50, 60, 2), (0, 1), "background", 0),
    ((300, 200, 4), (0, 1), "one_zero", 0),
    ((9, 7, 2000), (2,), "sparse", 0),
    ((4097, 3, 2), (0, 1), "sparse", 2),
    ((6000, 2, 2), (0, 1), "sparse", 2),
]


def _edt_mask(kind, shape, rng):
    """A boolean mask (nonzero = foreground) of one of EDT_CASES' kinds."""
    if kind == "random":
        return rng.random(shape) > 0.3
    if kind == "background":
        return np.zeros(shape, bool)
    if kind == "sparse":
        return rng.random(shape) > 0.002
    b = np.ones(shape, bool)
    if kind == "ends":  # slice 0: a zero at k = 0 of each axis-0 row; 1: k = n-1; 2: both
        b[0, :, 0::2] = False
        b[-1, :, 1:] = False
    else:  # one_zero: one background voxel in each z-slice
        for z in range(shape[-1]):
            b[rng.integers(shape[0]), rng.integers(shape[1]), z] = False
    return b


def _ulps(got, want):
    """The largest distance in float32 steps between two non-negative
    float32 tensors."""
    return int((got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("case", range(len(EDT_CASES)))
def test_edt_pass_equals_plain_exactly(cuda, case):
    shape, axes, kind, ulps = EDT_CASES[case]
    rng = np.random.default_rng(case)
    b = torch.from_numpy(_edt_mask(kind, shape, rng)).to(cuda)
    n_axes = len(shape) if axes is None else len(axes)
    before = EDT_PASS.launches
    got = edt(b, axes=axes)
    torch.cuda.synchronize()
    assert EDT_PASS.launches == before + n_axes
    want = edt_plain(b, axes=axes)
    assert got.shape == want.shape and got.dtype == torch.float32
    if ulps == 0:
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        assert _ulps(got, want) <= ulps


def _check_axis_pass(d, ulps):
    """K2's pass on each axis of ``d`` against the plain pass: one launch
    per axis, within ``ulps`` float32 steps (0: equal bits)."""
    for axis in range(d.ndim):
        before = EDT_PASS.launches
        got = edt_axis_pass(d, axis)
        torch.cuda.synchronize()
        assert EDT_PASS.launches == before + 1
        want = _axis_pass_plain(d, axis)
        if ulps == 0:
            assert torch.equal(got, want), (axis, float((got - want).abs().max()))
        else:
            assert _ulps(got, want) <= ulps, axis


def test_edt_axis_pass_integer_values_equal_plain_exactly(cuda):
    """Integer-valued d below 2^24 (the sums of squares the second pass
    sees) with float32(1e12) mixed in: equal bits."""
    rng = np.random.default_rng(7)
    d = rng.integers(0, 2**24, (310, 47, 3)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = 1e12
    _check_axis_pass(torch.from_numpy(d).to(cuda), 0)


def test_edt_axis_pass_real_values_within_one_ulp(cuda):
    """Non-integer float32 d, uniform in [0, 1000) and spread over 37
    decades: the stated 1-ulp tolerance (0 measured)."""
    rng = np.random.default_rng(8)
    d = (rng.random((290, 33, 2)) * 1000).astype(np.float32)
    d[..., 1] = 10.0 ** rng.uniform(-30, 7, d.shape[:2])
    _check_axis_pass(torch.from_numpy(d).to(cuda), 1)


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


def _check_dot(x, w, route):
    """K3 on ``x @ w`` against its plain version: one launch, on ``route``."""
    before = dict(DOT_BLOCKED.route_launches)
    got = dot_blocked(x, w)
    torch.cuda.synchronize()
    assert DOT_BLOCKED.route_launches == {**before, route: before[route] + 1}
    want = dot_blocked_plain(x, w)
    assert got.shape == want.shape == (*x.shape[:-1], w.shape[1]) and got.dtype == x.dtype
    scale = max(1.0, float(want.float().abs().max()))
    # as for K1: float32 sums in other orders; bf16 rounds the float32 sum once
    tol = 1e-5 * scale if x.dtype == torch.float32 else 2.0**-7 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (tuple(x.shape), tuple(w.shape), err, tol)


def _dot_inputs(xs, n, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(xs, np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal((xs[-1], n), np.float32) / np.sqrt(xs[-1]))
    return x, w.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(DOT_CASES)))
def test_dot_blocked_matches_plain(cuda, case, dtype):
    xs, n = DOT_CASES[case]
    x, w = _dot_inputs(xs, n, dtype, case, cuda)
    route = dot_blocked_route(dtype, xs[-1], n)
    # only bf16 (2, 7, 9, 72) @ [72, 16] has K and N multiples of 8
    assert route == ("ring" if dtype == torch.bfloat16 and case == 1 else "basic")
    _check_dot(x, w, route)


# K3's ring path (bfloat16, K % 8 == 0, N % 8 == 0): M ragged against the
# row tile (and a single row, and exactly one 256-row tile); K not a multiple
# of the 64-deep stage (8, 24, 72, 136: the zero fill) and deep (2304); N 8
# to 384 across every column tile (64 wide from N = 8 to 64, zeros past N;
# 128, 192, 256; above 256 several tiles, the last ragged at 264); enough
# tiles (up to 418) that each persistent block walks several.
DOT_RING_CASES = [
    ((1, 1, 1, 24), 8),
    ((2, 7, 9, 72), 16),
    ((1, 11, 13, 136), 40),
    ((3, 17, 5, 64), 32),
    ((1, 300, 3, 24), 128),
    ((2, 9, 31, 136), 256),
    ((1, 13, 29, 72), 384),
    ((1, 5, 77, 768), 384),
    ((1, 3, 100, 2304), 128),
    ((1, 1, 129, 8), 264),
    ((1, 2, 67, 576), 64),
    ((2, 5, 41, 40), 136),
    ((1, 7, 53, 264), 192),
    ((1, 1, 256, 128), 128),
    ((1, 100, 500, 72), 16),
    ((1, 50, 1000, 576), 128),
    ((1, 40, 999, 768), 384),
]


@pytest.mark.parametrize("case", range(len(DOT_RING_CASES)))
def test_dot_blocked_ring_path_matches_plain(cuda, case):
    xs, n = DOT_RING_CASES[case]
    assert dot_blocked_route(torch.bfloat16, xs[-1], n) == "ring"
    x, w = _dot_inputs(xs, n, torch.bfloat16, 200 + case, cuda)
    _check_dot(x, w, "ring")


def test_dot_blocked_ring_path_copies_misaligned_input(cuda):
    """An x or w that does not start on a 16-byte boundary is copied once
    to an aligned allocation and still takes the ring path."""
    x, w = _dot_inputs((1, 9, 21, 72), 40, torch.bfloat16, 300, cuda)
    xm = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view(x.shape)
    wm = torch.empty(w.numel() + 1, device=cuda, dtype=w.dtype)[1:].view(w.shape)
    xm.copy_(x)
    wm.copy_(w)
    assert xm.data_ptr() % 16 and wm.data_ptr() % 16 and xm.is_contiguous()
    for a, b in ((xm, w), (x, wm), (xm, wm)):
        _check_dot(a, b, "ring")


def test_dot_blocked_route_is_the_c_entry_points(cuda):
    """The C entry point decides the path; the Python rule, which the
    wrapper counts launches by, names the same one."""
    path, _ = build(DOT_BLOCKED.source)
    route = ctypes.CDLL(str(path)).dot_blocked_route
    route.argtypes, route.restype = [ctypes.c_int] * 3, ctypes.c_int
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for k in range(0, 137):
            for n in (1, 5, 8, 16, 33, 40, 128, 384):
                assert DOT_ROUTES[route(code, k, n)] == dot_blocked_route(dtype, k, n)


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


def test_sharded_tile_engine_on_one_card_repeated(cuda, monkeypatch):
    """The X-sharded tile engine on a mesh that repeats the card: every
    shard runs K1 (the small net's 7 valid convs per tile batch, two tile
    batches per 32-wide slab), and the gathered map equals the
    single-device engine's (K1 computes each voxel alike at any batch
    index; cuDNN's float32 transposed convs are pinned deterministic, or
    they move the map by ~1e-7 from run to run)."""
    from hcunet_tpu_torch.config import TileConfig, UNetConfig
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
    from hcunet_tpu_torch.models.unet import init_unet
    from hcunet_tpu_torch.parallel.mesh import make_mesh
    from hcunet_tpu_torch.parallel.tiled import sharded_tiled_forward

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = UNetConfig(feature_sizes=(8, 16), kernel1=(3, 3, 2), kernel2=(3, 3, 1),
                     upsample_kernel=(4, 4, 2), max_pool_kernel=(2, 2, 1),
                     upsample_stride=(2, 2, 1), groups=1)
    model = init_unet(cfg, torch.Generator().manual_seed(0)).eval()
    apply = compile_serving_apply(model, dtype=torch.float32, device=cuda)
    tiles = TileConfig(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=2)
    mesh = make_mesh({"spatial": 2}, [cuda] * 2)
    vol = torch.rand((1, 64, 40, 8, 4), device=cuda)
    run = sharded_tiled_forward(apply, mesh, cfg, tiles)
    before = CONV3D_VALID.launches
    got = run(vol)
    torch.cuda.synchronize()
    assert CONV3D_VALID.launches - before == 7 * 2 * 2
    want = predict_segmentation_mask(apply, vol, cfg, tiles, use_probability_map=True,
                                     device=cuda)
    assert torch.equal(got, want)


def test_data_parallel_step_launches_per_replica(cuda):
    """One data-parallel ``UNetTrainer`` step over the card repeated twice:
    each replica launches K1 for its 7 forward convs and 6 input gradients
    (none for the first conv), and the loss equals the single-device step's
    on the global batch within 1e-4."""
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.models.unet import init_unet
    from hcunet_tpu_torch.parallel.mesh import make_mesh
    from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer

    cfg = UNetConfig(feature_sizes=(8, 16), kernel1=(3, 3, 2), kernel2=(3, 3, 1),
                     upsample_kernel=(4, 4, 2), max_pool_kernel=(2, 2, 1),
                     upsample_stride=(2, 2, 1), groups=1)
    x = torch.rand((4, 48, 48, 8, 4), device=cuda)
    mask = (torch.rand((4, 48, 48, 8, 1), device=cuda) > 0.7).float()
    losses = []
    for mesh in (make_mesh({"data": 2}, [cuda] * 2), None):
        trainer = UNetTrainer(init_unet(cfg, torch.Generator().manual_seed(0)), None,
                              TrainConfig(log_every=0), mesh=mesh,
                              device=None if mesh else cuda)
        fwd, grad = CONV3D_VALID.launches, CONV3D_VALID_INPUT_GRAD.launches
        losses.append(trainer.train_step(x, mask, torch.ones_like(mask)))
        torch.cuda.synchronize()
        replicas = 2 if mesh else 1
        assert CONV3D_VALID.launches - fwd == 7 * replicas
        assert CONV3D_VALID_INPUT_GRAD.launches - grad == 6 * replicas
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
