"""K1's zero padding on the CPU: ``conv3d_valid(..., padding=)``, its input
gradient and :class:`Conv3dValidFunction` with a padding (their plain
versions here; on the card K1's basic path pads inside the kernel) against
the JAX package's ``conv_same`` at stride 1, ``jax.grad`` of it, and plain
autograd through ``F.pad``.  Inputs come from seeded numpy generators; the
tolerance is 1e-5 of the output's scale, as ``test_torch_port_recurrent.py``
holds ``conv_same``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hcunet_tpu.ops.conv import conv_same as jax_conv_same
from hcunet_tpu.ops.conv import conv_valid as jax_conv_valid
from hcunet_tpu_torch.ops.conv import (
    K1_BASIC_MAX_TAPS,
    _k1_launch,
    conv3d_valid,
    conv3d_valid_input_grad,
    conv3d_valid_plain,
    conv_same,
)

# name: (x shape, w shape, dilation, padding): RDCNet's five dilated 5^3
# convs (padding 2d) narrowed to 4-6 channels, a zero padding, an
# asymmetric one with per-axis dilation
CASES = {
    **{f"rdcnet_d{d}": ((1, 7, 6, 5, 5), (5, 5, 5, 5, 4 + d % 3), d, 2 * d) for d in range(1, 6)},
    "zero": ((2, 6, 5, 4, 4), (3, 3, 2, 4, 6), 1, 0),
    "asymmetric": ((1, 7, 6, 5, 6), (3, 3, 3, 6, 5), (1, 2, 1), ((0, 2), (3, 1), (2, 0))),
}


def _inputs(name):
    xs, ws, dil, pad = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:4]))).astype(np.float32)
    b = rng.standard_normal(ws[-1:]).astype(np.float32)
    return x, w, b, dil, pad


def _jax_conv(x, w, b, dil, pad):
    """The JAX twin: ``conv_same`` at stride 1 for a symmetric padding,
    ``conv_valid`` of the ``jnp.pad``-ded input for an asymmetric one."""
    if isinstance(pad, int):
        return jax_conv_same(x, w, b, stride=1, padding=pad, dilation=dil)
    return jax_conv_valid(jnp.pad(x, ((0, 0), *pad, (0, 0))), w, b, dilation=dil)


def _scale_close(got, want, share=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=share * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_padded_conv_matches_jax_conv_same(name):
    x, w, b, dil, pad = _inputs(name)
    want = np.asarray(_jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil, pad))
    t = [torch.from_numpy(a) for a in (x, w, b)]
    _scale_close(conv3d_valid(*t, False, dil, pad).numpy(), want)
    _scale_close(conv3d_valid(*t, True, dil, pad).numpy(), np.maximum(want, 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_padded_input_grad_matches_jax_grad(name):
    x, w, _b, dil, pad = _inputs(name)
    out_shape = jax.eval_shape(lambda x: _jax_conv(x, w, None, dil, pad), jnp.asarray(x)).shape
    gy = np.random.default_rng(len(name)).standard_normal(out_shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(_jax_conv(x, jnp.asarray(w), None, dil, pad) * gy))(
        jnp.asarray(x))
    got = conv3d_valid_input_grad(torch.from_numpy(gy), torch.from_numpy(w), dil, padding=pad)
    assert got.shape == x.shape
    _scale_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_with_padding_matches_autograd_through_pad(name):
    """``Conv3dValidFunction`` carrying the padding (K1 forward and input
    gradient on the card, the plain versions here) against plain autograd
    through ``F.pad`` and ``F.conv3d``: both gradients."""
    x0, w0, _b, dil, pad = _inputs(name)
    xs = [torch.from_numpy(x0).requires_grad_() for _ in range(2)]
    ws = [torch.from_numpy(w0).requires_grad_() for _ in range(2)]
    out = conv3d_valid(xs[0], ws[0], None, False, dil, pad)
    assert out.grad_fn is not None and "Conv3dValidFunction" in type(out.grad_fn).__name__
    pads = [(p, p) if isinstance(p, int) else p for p in ((pad,) * 3 if isinstance(pad, int) else pad)]
    xp = F.pad(xs[1], (0, 0, *pads[2], *pads[1], *pads[0]))
    ref = F.conv3d(xp.movedim(-1, 1), ws[1].permute(4, 3, 0, 1, 2),
                   dilation=(dil,) * 3 if isinstance(dil, int) else dil).movedim(1, -1)
    assert out.shape == ref.shape
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(tuple(out.shape)).astype(np.float32))
    (out * r).sum().backward()
    (ref * r).sum().backward()
    _scale_close(xs[0].grad.numpy(), xs[1].grad.numpy())
    _scale_close(ws[0].grad.numpy(), ws[1].grad.numpy())


@pytest.mark.parametrize("padding", [3, -1, ((0, 3), (0, 0), (1, 1)), (1, 1, 2)],
                         ids=["past", "negative", "high_past", "z_past"])
def test_padding_outside_zero_to_d_k_minus_1_raises(padding):
    """K1 takes 0 to d (k - 1) on each side: a (3, 3, 2) kernel at dilation
    1 takes at most (2, 2, 1)."""
    x = torch.zeros((1, 5, 5, 4, 2))
    w = torch.zeros((3, 3, 2, 2, 3), requires_grad=True)
    for fn in (lambda: conv3d_valid(x, w.detach(), padding=padding),
               lambda: conv3d_valid(x, w, padding=padding),
               lambda: conv3d_valid_input_grad(torch.zeros((1, 5, 5, 4, 3)), w.detach(),
                                               padding=padding)):
        with pytest.raises(ValueError, match="padding"):
            fn()


@pytest.mark.parametrize("padding", [1, (1, 1, 1), ((1, 1), (1, 1), (1, 1))],
                         ids=["int", "per_axis", "pairs"])
def test_padding_forms_agree(padding):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 5, 4, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 2)).astype(np.float32))
    want = conv3d_valid_plain(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), w)
    assert torch.equal(conv3d_valid(x, w, padding=padding), want)


def test_conv_same_hands_the_padding_to_the_conv():
    """``conv_same`` at stride 1 gives ``conv`` the unpadded input and the
    padding as ``padding=``; the output is the valid conv of the input
    padded by ``F.pad``."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 6, 5, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    seen = []

    def recording_conv(x, w, b=None, relu=False, dilation=1, padding=0):
        seen.append((tuple(x.shape), padding))
        return conv3d_valid_plain(x, w, b, relu, dilation, padding)

    out = conv_same(x, w, b, padding=1, relu=True, conv=recording_conv)
    assert seen == [((1, 6, 5, 4, 3), (1, 1, 1))]
    want = conv3d_valid_plain(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), w, b, True)
    assert torch.equal(out, want)


@pytest.mark.parametrize("k", [(11, 3, 3), (3, 3, 11)], ids=["x", "z"])
def test_basic_path_refuses_more_than_ten_taps_an_axis(k):
    """K1's basic path keeps 10 tap bits an axis: a wider kernel on it
    raises before anything is allocated or launched, on any device."""
    x = torch.zeros((1, 12, 12, 12, 3))
    w = torch.zeros((*k, 3, 2))
    assert K1_BASIC_MAX_TAPS == 10
    with pytest.raises(ValueError, match="at most 10 taps"):
        _k1_launch(x, w, None, False, (1, 1, 1), ((0, 0),) * 3)
    # on the ring path (bfloat16, Cin % 8 == 0) only the device is refused
    with pytest.raises(ValueError, match="no kernel for device"):
        _k1_launch(torch.zeros((1, 12, 12, 12, 8), dtype=torch.bfloat16),
                   torch.zeros((*k, 8, 2), dtype=torch.bfloat16), None, False, (1, 1, 1),
                   ((0, 0),) * 3)
