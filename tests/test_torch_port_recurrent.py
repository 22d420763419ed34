"""The recurrent family of the PyTorch port against the JAX package, on the
CPU: ``conv_same`` (K1's plain version at stride 1), the stacked parity
conv of a transposed conv with padding 2, ``RecursiveUNet`` and ``RDCNet``
against ``model.apply``, the weight converters both ways (also through the
JAX package's own ``runet_variables_from_torch_state_dict``), the configs
across packages, and the host clustering (``peak_local_max``,
``pixel_vec_to_cell``), exactly.

Tolerances: float32 convs at 1e-5 of the output's scale (two float32 sums
in different orders); the models at atol 5e-5, and 2e-4 at 10 timesteps,
JAX's own packed-vs-plain tolerances (the recurrence carries rounding
from step to step); RDCNet, whose state grows through its 10 residual
iterations to ~16, at 1e-5 of its output's scale.

``jax_recurrent`` and ``share_of_scale`` serve the other recurrent test
files too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hcunet_tpu.config as J
from hcunet_tpu.infer.compile_recurrent import _subpixel_taps
from hcunet_tpu.infer.vector_cluster import hist3d as jax_hist3d
from hcunet_tpu.infer.vector_cluster import pixel_vec_to_cell as jax_pixel_vec_to_cell
from hcunet_tpu.models.rdcnet import RDCNet as JaxRDCNet
from hcunet_tpu.models.runet import RecursiveUNet as JaxRecursiveUNet
from hcunet_tpu.ops.conv import conv_same as jax_conv_same
from hcunet_tpu.ops.conv import conv_transpose_torch as jax_conv_transpose
from hcunet_tpu.ops.peaks import peak_local_max as jax_peak_local_max
from hcunet_tpu.utils import port_torch
from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig, config_from_dict, config_to_dict
from hcunet_tpu_torch.infer.compile import subpixel_pads, subpixel_tconv_weights, tconv_subpixel
from hcunet_tpu_torch.infer.vector_cluster import hist3d, pixel_vec_to_cell
from hcunet_tpu_torch.ops.conv import conv_same, conv_transpose_torch
from hcunet_tpu_torch.ops.peaks import peak_local_max
from hcunet_tpu_torch.utils import port_jax
from hcunet_tpu_torch.models.rdcnet import RDCNet
from hcunet_tpu_torch.models.runet import RecursiveUNet
from tests.torch_port_support import randomize


# --- shared set-up of the recurrent family's tests ---------------------------


def jax_recurrent(family, spatial, seed=0, skip_bug=False, **config_kwargs):
    """``(port model, JAX model, JAX variables as numpy)`` for a
    ``RecursiveUNet`` (``family="runet"``) or an ``RDCNet`` (``"rdcnet"``):
    the variables' shapes from ``jax.eval_shape`` of the JAX init, every
    value from a seeded numpy generator (:func:`randomize`), and the port's
    model (float32, eval, on the CPU) holding them."""
    if family == "runet":
        jmodel = JaxRecursiveUNet(J.RUNetConfig(**config_kwargs), reference_skip_bug=skip_bug)
        model = RecursiveUNet(RUNetConfig(**config_kwargs), reference_skip_bug=skip_bug)
        to_port = port_jax.runet_state_dict_from_jax_variables
    else:
        jmodel = JaxRDCNet(J.RDCNetConfig(**config_kwargs))
        model = RDCNet(RDCNetConfig(**config_kwargs))
        to_port = port_jax.rdcnet_state_dict_from_jax_variables
    x = jax.ShapeDtypeStruct((1, *spatial, jmodel.config.in_channels), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(seed), x, train=False), x)
    rng = np.random.default_rng(seed)
    variables = {k: randomize(v, rng) for k, v in shapes.items()}
    model.load_state_dict(to_port(variables))
    return model.eval(), jmodel, variables


def share_of_scale(got, want) -> float:
    """``max |got - want| / max |want|``: how bf16 results are compared."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- tests ---------------------------------------------------------------------

# name: (x shape, w shape, stride, padding, dilation): the recurrent
# models' convs at small sizes
CONV_SAME_CASES = {
    "runet_3x3x3": ((2, 10, 9, 5, 9), (3, 3, 3, 9, 16), 1, 1, 1),
    "runet_out_1x1x1": ((1, 8, 8, 5, 16), (1, 1, 1, 16, 5), 1, 0, 1),
    **{
        f"rdcnet_dilation{d}": ((1, 8, 7, 6, 10), (5, 5, 5, 10, 10), 1, 2 * d, d)
        for d in range(1, 6)
    },
    "rdcnet_in_stride2": ((1, 9, 8, 7, 4), (3, 3, 3, 4, 10), 2, 1, 1),
}


def _scale_close(got, want, share=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=share * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CONV_SAME_CASES))
def test_conv_same_matches_jax(name):
    xs, ws, stride, pad, dil = CONV_SAME_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:4]))).astype(np.float32)
    b = rng.standard_normal(ws[-1:]).astype(np.float32)
    want = np.asarray(jax_conv_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=stride, padding=pad, dilation=dil))
    t = [torch.from_numpy(a) for a in (x, w, b)]
    got = conv_same(*t, stride=stride, padding=pad, dilation=dil)
    _scale_close(got.numpy(), want)
    relu = conv_same(*t, stride=stride, padding=pad, dilation=dil, relu=True)
    _scale_close(relu.numpy(), np.maximum(want, 0))
    # a gradient path: the bias and ReLU after the conv, the same values
    tw = t[1].clone().requires_grad_(True)
    with torch.enable_grad():
        graded = conv_same(t[0], tw, t[2], stride=stride, padding=pad, dilation=dil, relu=True)
    assert graded.requires_grad
    _scale_close(graded.detach().numpy(), np.maximum(want, 0))


@pytest.mark.parametrize("spatial", [(8, 8, 5), (7, 9, 6)], ids=["even", "odd"])
def test_tconv_subpixel_pad2_is_the_transposed_conv(spatial):
    """The RecursiveUNet's (6, 6, 5)/(2, 2, 1) transposed conv with padding
    2 as pad (1, 1, 2), one conv with the four stacked parity kernels,
    interleave: against ``conv_transpose_torch`` and the JAX package's, at
    1e-5 of the scale, for Cin 64 -> 32 (the gates) and 32 -> 16 (``up2``)."""
    for cin, cout in ((64, 32), (32, 16)):
        rng = np.random.default_rng(cin)
        x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
        w = (rng.standard_normal((6, 6, 5, cin, cout)) / np.sqrt(180 * cin)).astype(np.float32)
        b = rng.standard_normal(cout).astype(np.float32)
        tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
        w_sub = subpixel_tconv_weights(tw)
        assert w_sub.shape == (3, 3, 5, cin, 4 * cout)
        got = tconv_subpixel(tx, w_sub, tb.repeat(4), pad=2)
        want = conv_transpose_torch(tx, tw, tb, stride=(2, 2, 1), padding=2)
        assert got.shape == want.shape == (2, 2 * spatial[0], 2 * spatial[1], spatial[2], cout)
        _scale_close(got.numpy(), want.numpy())
        jwant = jax_conv_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   stride=(2, 2, 1), padding=2)
        _scale_close(got.numpy(), np.asarray(jwant))


def test_subpixel_taps_are_the_jax_rule():
    """For k = 6, padding 2 the pads and each parity's kernel are those of
    the JAX package's ``_subpixel_taps`` (w indices, flipped in z); the
    U-Net's (8, 8, 2) at padding 0 keeps its pads; odd kernels and odd
    paddings take no subpixel route in either package."""
    assert subpixel_pads((6, 6, 5), 2) == (1, 1, 2)
    assert subpixel_pads((8, 8, 2)) == (3, 3, 1)
    for k, pad in ((5, 2), (6, 1), (6, 6), (3, 0)):
        assert subpixel_pads((k, k, 5), pad) is None
        assert None in (_subpixel_taps(k, pad, 0), _subpixel_taps(k, pad, 1))
    w = np.random.default_rng(0).standard_normal((6, 6, 5, 3, 2)).astype(np.float32)
    stacked = subpixel_tconv_weights(torch.from_numpy(w)).numpy()
    for rx in (0, 1):
        for ry in (0, 1):
            xi, px = _subpixel_taps(6, 2, rx)
            yi, py = _subpixel_taps(6, 2, ry)
            assert (px, py) == (1, 1)
            want = w[np.asarray(xi)][:, np.asarray(yi)][:, :, ::-1]
            k = 2 * rx + ry
            np.testing.assert_array_equal(stacked[..., 2 * k: 2 * k + 2], want)


# name: (spatial, config kwargs, skip bug, atol)
RUNET_CASES = {
    "t2": ((16, 16, 5), dict(timesteps=2), False, 5e-5),
    "t10": ((16, 16, 5), dict(timesteps=10), False, 2e-4),
    "skip_bug_t2": ((16, 16, 5), dict(timesteps=2), True, 5e-5),
    "skip_bug_t10": ((16, 16, 5), dict(timesteps=10), True, 2e-4),
    "odd_xy_t2": ((17, 15, 5), dict(timesteps=2), False, 5e-5),
}


@pytest.mark.parametrize("name", sorted(RUNET_CASES))
def test_recursive_unet_matches_jax(name):
    """``RecursiveUNet`` (16/32/64) against the JAX ``model.apply``, with and
    without ``reference_skip_bug``, at 2 and 10 timesteps, and at an odd
    x/y (the state zero-padded back); every state of the sequence too."""
    spatial, kw, skip_bug, atol = RUNET_CASES[name]
    model, jmodel, variables = jax_recurrent("runet", spatial, skip_bug=skip_bug, **kw)
    x = np.random.default_rng(1).standard_normal((2, *spatial, 4)).astype(np.float32)
    want, want_seq = jmodel.apply(variables, jnp.asarray(x), train=False, return_sequence=True)
    with torch.no_grad():
        got, seq = model(torch.from_numpy(x), return_sequence=True)
    assert got.shape == want.shape == (2, *spatial, 5)
    assert seq.shape == want_seq.shape == (kw["timesteps"], 2, *spatial, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), rtol=0, atol=atol)


def test_rdcnet_matches_jax():
    """``RDCNet`` (complexity 10, 10 iterations) on 16^2 x 10 against the
    JAX ``model.apply`` at 1e-5 of its output's scale."""
    model, jmodel, variables = jax_recurrent("rdcnet", (16, 16, 10), timesteps=10)
    x = np.random.default_rng(1).standard_normal((1, 16, 16, 10, 4)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    _scale_close(got, want)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_converters_both_ways_and_through_jax(family):
    """JAX variables -> the port's state dict -> JAX variables is the
    identity; the JAX package's ``*_variables_from_torch_state_dict`` reads
    the port's state dict to the same variables; for RDCNet the JAX
    package's inverse writes the port's state dict."""
    model, _jm, variables = jax_recurrent(family, (16, 16, 10), timesteps=2)
    sd = model.state_dict()
    if family == "runet":
        back = port_jax.jax_variables_from_runet_state_dict(sd)
        through_jax = port_torch.runet_variables_from_torch_state_dict(sd)
    else:
        back = port_jax.jax_variables_from_rdcnet_state_dict(sd)
        through_jax = port_torch.rdcnet_variables_from_torch_state_dict(sd)
        jsd = port_torch.rdcnet_state_dict_from_variables(variables)
        assert jsd.keys() == sd.keys()
        for k in sd:
            assert torch.equal(jsd[k], sd[k]), k
    _same_tree(back, variables)
    _same_tree(through_jax, variables)
    # every tensor of the port's model is named and filled by the converter
    assert set(sd) == set(type(model)(model.config).state_dict())


@pytest.mark.parametrize("cfg_name", ["RUNetConfig", "RDCNetConfig"])
def test_recurrent_configs_cross_packages(cfg_name):
    """``config_to_dict`` of each package is read by the other's
    ``config_from_dict`` to an equal config (defaults and a non-default)."""
    port_cls = {"RUNetConfig": RUNetConfig, "RDCNetConfig": RDCNetConfig}[cfg_name]
    jax_cls = getattr(J, cfg_name)
    for kw in ({}, {"timesteps": 3, "out_channels": 4}):
        port_cfg, jax_cfg = port_cls(**kw), jax_cls(**kw)
        assert config_from_dict(json.loads(json.dumps(J.config_to_dict(jax_cfg)))) == port_cfg
        assert J.config_from_dict(json.loads(json.dumps(config_to_dict(port_cfg)))) == jax_cfg


def _vector_field(seed=0, shape=(40, 36, 8)):
    """Offsets that point each voxel of four blobs to its blob's center, in
    the r-unet channel order (z, y, x), with noise; and a mask."""
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    idx = np.indices(shape).astype(np.float64)
    centers = np.array([[10, 9, 3], [28, 10, 4], [12, 26, 5], [30, 27, 3]], np.float64)
    d = ((idx[None] - centers[:, :, None, None, None]) ** 2).sum(1)
    owner = d.argmin(0)
    mask = (d.min(0) < 40).astype(np.float32) * 0.9 + rng.random(shape) * 0.1
    off = centers[owner].transpose(3, 0, 1, 2) - idx + rng.normal(0, 0.7, (3, *shape))
    vector = np.stack([off[2], off[1], off[0]], axis=-1).astype(np.float32)
    return vector, mask


def test_peak_local_max_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((20, 18, 6))
    img[5, 5, 3] = img[12, 11, 2] = 3.0  # two tied peaks: the order must match too
    for kw in ({}, {"min_distance": 2, "num_peaks": 5}, {"threshold_rel": 0.5},
               {"exclude_border": False, "threshold_abs": 0.9}):
        np.testing.assert_array_equal(peak_local_max(img, **kw), jax_peak_local_max(img, **kw))


def test_pixel_vec_to_cell_matches_jax():
    """The vote histogram and the labels on a synthetic field of four
    cells, exactly; four cells found."""
    vector, mask = _vector_field()
    centers = np.indices(mask.shape).astype(np.float64)
    centers += np.stack([vector[..., 2], vector[..., 1], vector[..., 0]])
    np.testing.assert_array_equal(hist3d(centers), jax_hist3d(centers))
    got = pixel_vec_to_cell(vector, mask, num_peaks=10)
    want = jax_pixel_vec_to_cell(vector, mask, num_peaks=10)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[mask > 0.5])) == 4
