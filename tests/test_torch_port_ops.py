"""Ops of the PyTorch port against their JAX twins, and K1's plain version
against the three TPU Pallas conv kernels it replaces.

Inputs come from a seeded numpy generator and go to both sides as numpy
arrays.  Tolerances: float32 everywhere; 2e-5 absolute covers the different
summation orders of XLA's and PyTorch's CPU convolutions on O(1) values.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hcunet_tpu.config as jcfg
import hcunet_tpu.core.padding as jpad
import hcunet_tpu.core.shapes as jshapes
import hcunet_tpu.ops.conv as jconv
import hcunet_tpu.ops.filters as jfilters
import hcunet_tpu_torch.config as tcfg
import hcunet_tpu_torch.core.padding as tpad
import hcunet_tpu_torch.core.shapes as tshapes
import hcunet_tpu_torch.ops.conv as tconv
import hcunet_tpu_torch.ops.filters as tfilters

ATOL = 2e-5
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# --------------------------------------------------------------- conv ops

CONV_CASES = {
    # name: (x shape, w shape, groups, dilation, stride)
    "3d": ((2, 9, 8, 6, 4), (3, 3, 2, 4, 16), 1, 1, 1),
    "3d_groups2": ((1, 8, 9, 5, 8), (3, 3, 2, 4, 16), 2, 1, 1),
    "3d_dilation2": ((1, 11, 10, 7, 4), (3, 3, 2, 4, 8), 1, 2, 1),
    "3d_1x1": ((2, 5, 6, 4, 16), (1, 1, 1, 16, 1), 1, 1, 1),
    "2d": ((2, 12, 11, 4), (3, 3, 4, 8), 1, 1, 1),
    "3d_stride2": ((1, 9, 9, 6, 4), (3, 3, 2, 4, 8), 1, 1, 2),
    "3d_groups16": ((1, 6, 6, 4, 16), (3, 3, 1, 1, 16), 16, 1, 1),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_valid_matches_jax(case):
    xs, ws, groups, dil, stride = CONV_CASES[case]
    rng = np.random.default_rng(1)
    fan = int(np.prod(ws[:-1]))
    x, w = _rand(rng, *xs), _rand(rng, *ws, scale=fan**-0.5)
    b = _rand(rng, ws[-1])
    want = jconv.conv_valid(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        stride=stride, dilation=dil, groups=groups,
    )
    got = tconv.conv_valid(
        _t(x), _t(w), _t(b), stride=stride, dilation=dil, groups=groups
    )
    _close(got, want)


@pytest.mark.parametrize(
    "xs,ws,stride,padding",
    [
        ((1, 5, 6, 4, 8), (4, 4, 2, 8, 4), (2, 2, 1), 0),
        ((2, 4, 4, 3, 6), (8, 8, 2, 6, 3), (2, 2, 1), 0),
        ((1, 5, 5, 6), (3, 3, 6, 4), (2, 2), 1),
    ],
    ids=["3d", "3d_k8", "2d_pad1"],
)
def test_conv_transpose_matches_jax(xs, ws, stride, padding):
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, *xs), _rand(rng, *ws, scale=0.2), _rand(rng, ws[-1])
    want = jconv.conv_transpose_torch(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding
    )
    got = tconv.conv_transpose_torch(_t(x), _t(w), _t(b), stride=stride, padding=padding)
    _close(got, want)


@pytest.mark.parametrize(
    "xs,k", [((2, 9, 8, 5, 3), (2, 2, 1)), ((1, 7, 6, 4), (2, 2))], ids=["3d", "2d"]
)
def test_max_pool_matches_jax(xs, k):
    x = _rand(np.random.default_rng(3), *xs)
    _close(tconv.max_pool(_t(x), k), jconv.max_pool(jnp.asarray(x), k), atol=0)


@pytest.mark.parametrize("groups", [2, 4])
def test_block_diagonal_weights_matches_jax(groups):
    w = _rand(np.random.default_rng(4), 3, 3, 2, 3, 8)
    _close(
        tconv.block_diagonal_weights(_t(w), groups),
        jconv.block_diagonal_weights(jnp.asarray(w), groups),
        atol=0,
    )


def _bn_params(rng, c):
    return (
        (rng.random(c) + 0.5).astype(np.float32),
        _rand(rng, c, scale=0.1),
        _rand(rng, c, scale=0.1),
        (rng.random(c) + 0.5).astype(np.float32),
    )


@pytest.mark.parametrize("with_bias", [True, False])
def test_fold_bn_into_conv_matches_jax(with_bias):
    rng = np.random.default_rng(5)
    w = _rand(rng, 3, 3, 2, 4, 16)
    b = _rand(rng, 16) if with_bias else None
    bn = _bn_params(rng, 16)
    jw, jb = jconv.fold_bn_into_conv(
        jnp.asarray(w), None if b is None else jnp.asarray(b), *map(jnp.asarray, bn)
    )
    tw, tb = tconv.fold_bn_into_conv(
        _t(w), None if b is None else _t(b), *map(_t, bn)
    )
    _close(tw, jw, atol=1e-6)
    _close(tb, jb, atol=1e-6)


def test_batch_norm_inference_matches_jax():
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 4, 3, 8)
    bn = _bn_params(rng, 8)
    _close(
        tconv.batch_norm_inference(_t(x), *map(_t, bn)),
        jconv.batch_norm_inference(jnp.asarray(x), *map(jnp.asarray, bn)),
        atol=1e-6,
    )


# --------------------------------------------------------------- padding

@pytest.mark.parametrize(
    "xs,pad",
    [((1, 7, 6, 5, 2), (3, 2, 1)), ((2, 4, 5, 3, 1), (4, 5, 3)), ((1, 6, 5, 3), (0, 2))],
    ids=["3d", "pad_equals_size", "2d"],
)
def test_reflection_pad_matches_jax(xs, pad):
    x = _rand(np.random.default_rng(7), *xs)
    _close(tpad.reflection_pad(_t(x), pad), jpad.reflection_pad(jnp.asarray(x), pad), atol=0)


def test_reflection_pad_rejects_pad_larger_than_axis():
    x = torch.zeros((1, 4, 5, 3, 1))
    with pytest.raises(ValueError, match="larger than axis size"):
        tpad.reflection_pad(x, (5, 1, 1))
    with pytest.raises(ValueError, match="negative pad"):
        tpad.reflection_pad(x, (-1, 1, 1))


@pytest.mark.parametrize(
    "target,mode",
    [((9, 8, 5), "symmetric"), ((20, 6, 4), "symmetric"), ((10, 9, 7), "edge")],
    ids=["symmetric", "symmetric_falls_back_to_edge", "edge"],
)
def test_pad_to_shape_matches_jax(target, mode):
    x = _rand(np.random.default_rng(8), 1, 6, 5, 4, 2)
    _close(
        tpad.pad_to_shape(_t(x), target, mode),
        jpad.pad_to_shape(jnp.asarray(x), target, mode),
        atol=0,
    )


# --------------------------------------------------------------- filters

@pytest.mark.parametrize(
    "sigma,axes", [(3.0, (1, 2, 3)), (1.5, None), (0.7, (1, 3))],
    ids=["pipeline_sigma3", "all_axes", "two_axes"],
)
def test_gaussian_blur_matches_jax(sigma, axes):
    x = np.random.default_rng(9).random((1, 20, 17, 9, 1)).astype(np.float32)
    _close(
        tfilters.gaussian_blur(_t(x), sigma, axes=axes),
        jfilters.gaussian_blur(jnp.asarray(x), sigma, axes=axes),
        atol=1e-6,
    )
    _close(tfilters.gaussian_kernel1d(sigma), jfilters.gaussian_kernel1d(sigma), atol=1e-7)


# --------------------------------------------------------------- shapes and config

@pytest.mark.parametrize(
    "spatial", [(156, 156, 10), (496, 496, 23), (100, 100, 9), (188, 188)]
)
def test_shape_algebra_matches_jax(spatial):
    cfg3, cfg2 = jcfg.UNetConfig.production_3d(), jcfg.UNetConfig.readme_2d()
    kw = (cfg3 if len(spatial) == 3 else cfg2).shape_kwargs()
    assert tshapes.unet_output_shape(spatial, **kw) == jshapes.unet_output_shape(spatial, **kw)
    assert tshapes.unet_shrinkage(spatial, **kw) == jshapes.unet_shrinkage(spatial, **kw)
    core, halo = (48,) * len(spatial), (20,) * len(spatial)
    assert tshapes.regular_tile_grid(spatial, core, halo) == jshapes.regular_tile_grid(
        spatial, core, halo
    )
    for p, e, s in [(20, 48, spatial[0]), (4, 8, spatial[-1]), (10, 300, 120)]:
        assert tshapes.calculate_indexes(p, e, s, s + 2 * p) == jshapes.calculate_indexes(
            p, e, s, s + 2 * p
        )


@pytest.mark.parametrize("gib", [16, 80])
@pytest.mark.parametrize("name", ["production_3d", "readme_2d"])
def test_auto_tile_config_matches_jax(name, gib):
    t = tcfg.auto_tile_config(getattr(tcfg.UNetConfig, name)(), hbm_bytes=gib * 2**30)
    j = jcfg.auto_tile_config(getattr(jcfg.UNetConfig, name)(), hbm_bytes=gib * 2**30)
    assert (t.eval_size, t.pad, t.batch) == (j.eval_size, j.pad, j.batch)


# --------------------------------------------------------------- Pallas kernels

@pytest.fixture(scope="module")
def probe():
    """``scripts/probe_pallas_conv.py``, imported by path (it is a script)."""
    path = os.path.join(REPO_ROOT, "scripts", "probe_pallas_conv.py")
    spec = importlib.util.spec_from_file_location("probe_pallas_conv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["packed", "im2col", "gsum"])
def test_conv3d_valid_plain_matches_pallas_conv(probe, monkeypatch, variant):
    """K1's plain version on the packed layout ``[B, X, Y, nb, Lin]`` x
    ``[kx, ky, kzb, Lin, Lout]`` equals each TPU Pallas conv, run in
    interpret mode.  atol 1e-5: float32 sums of 144 O(1/12) terms."""
    monkeypatch.setattr(
        probe.pl, "pallas_call", functools.partial(probe.pl.pallas_call, interpret=True)
    )
    rng = np.random.default_rng(10)
    x = rng.random((1, 10, 12, 3, 8), dtype=np.float32)
    w = _rand(rng, 3, 3, 2, 8, 8, scale=144**-0.5)
    b = _rand(rng, 8)
    kernel = {
        "packed": functools.partial(probe.pallas_conv_packed, tx=8),
        "im2col": functools.partial(probe.pallas_conv_im2col, tx=8, ty=10),
        "gsum": functools.partial(probe.pallas_conv_gsum, tx=8),
    }[variant]
    for relu in (False, True):
        want = kernel(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), kx=3, ky=3, kzb=2, relu=relu
        )
        got = tconv.conv3d_valid_plain(_t(x), _t(w), _t(b), relu)
        _close(got, want, atol=1e-5)
