"""Shared set-up of the PyTorch port's parity tests: JAX U-Nets with
non-trivial random weights, and the same weights in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.infer.compile import compile_serving_apply as jax_serving_apply
from hcunet_tpu.models.unet import UNet as JaxUNet
from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.models.unet import UNet
from hcunet_tpu_torch.train.parity import FAR, bn_cancelled, flat, trajectory_gaps  # noqa: F401
from hcunet_tpu_torch.utils.port_jax import unet_state_dict_from_jax_variables

# the two-level net of __graft_entry__.py and test_serving_compile.py
SMALL = dict(
    feature_sizes=(8, 16), kernel1=(3, 3, 2), kernel2=(3, 3, 1),
    upsample_kernel=(4, 4, 2), max_pool_kernel=(2, 2, 1),
    upsample_stride=(2, 2, 1), groups=1,
)


def randomize(tree, rng, path=()):
    """Random values for every leaf of a JAX U-Net variable tree of shapes:
    He-normal kernels, and random biases, BN scale/bias and BN mean/var
    (``init_unet``'s biases 0, mean 0 and var 1 would make BN folding
    trivial)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng, path + (k,))
            continue
        if k.endswith("kernel"):
            std = np.sqrt(2.0 / np.prod(v.shape[:-1]))
            v = rng.standard_normal(v.shape) * std
        elif k in ("scale", "var"):
            v = rng.random(v.shape) + 0.5
        else:  # biases and means
            scale = 0.1 if "BatchNorm_0" in path or k == "mean" else 0.05
            v = rng.standard_normal(v.shape) * scale
        out[k] = np.asarray(v, np.float32)
    return out


def jax_unet(config_kwargs, spatial, seed=0):
    """``(port config, JAX model, JAX variables as numpy)`` for a config.

    The variable tree's shapes come from ``jax.eval_shape`` of the model's
    init (tracing only: running the init op by op takes tens of seconds on
    the CPU) and every value from a seeded numpy generator."""
    jcfg = JaxUNetConfig(**config_kwargs)
    model = JaxUNet(jcfg)
    x = jax.ShapeDtypeStruct((1, *spatial, jcfg.in_channels), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(seed), x, train=False), x
    )
    rng = np.random.default_rng(seed)
    variables = {
        "params": randomize(shapes["params"], rng),
        "batch_stats": randomize(shapes["batch_stats"], rng),
    }
    return UNetConfig(**config_kwargs), model, variables


def port_unet(cfg, variables):
    """The port's UNet holding the JAX variables' weights."""
    model = UNet(cfg)
    model.load_state_dict(unet_state_dict_from_jax_variables(variables, cfg))
    return model.eval()


def assert_forwards_match(unet, spatial, batch, atol=5e-5, **jax_serving_kwargs):
    """Port forward and serving forward against JAX ``apply`` and serving,
    for ``unet = jax_unet(...)``; ``jax_serving_kwargs``
    (``subpixel_tconv=``) go to the JAX serving compiler alone."""
    cfg, jmodel, variables = unet
    x = np.random.default_rng(1).random((batch, *spatial, cfg.in_channels), np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    want_serving = np.asarray(
        jax_serving_apply(jmodel, variables, dtype=jnp.float32, **jax_serving_kwargs)(
            jnp.asarray(x)
        )
    )
    model = port_unet(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    got_serving = compile_serving_apply(
        model, dtype=torch.float32, device="cpu"
    )(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got_serving.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got_serving, want_serving, atol=atol, rtol=0)
    np.testing.assert_allclose(got_serving, want, atol=atol, rtol=0)


# --- training ---------------------------------------------------------------

SMALL_G2 = dict(SMALL, groups=2)
TRAIN_SPATIAL = (32, 32, 6)


def train_batch(seed=0, spatial=TRAIN_SPATIAL):
    rng = np.random.default_rng(seed)
    img = rng.random((1, *spatial, 4)).astype(np.float32)
    mask = (rng.random((1, *spatial, 1)) > 0.7).astype(np.float32)
    pwl = rng.random((1, *spatial, 1)).astype(np.float32)
    return img, mask, pwl


def assert_grads_match(got, want, rtol):
    """Per tensor, ``|got - want| <= rtol * max|want|``; a BN-cancelled
    bias's gradient (0 up to rounding on both sides) within ``rtol`` of its
    layer's kernel gradient's scale."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if bn_cancelled(path):
            kernel = path[:-1] + (("up_kernel",) if path[-1] == "up_bias" else ("kernel",))
            scale = float(np.abs(want[kernel]).max())
            assert float(np.abs(w).max()) <= 1e-4 * scale, path
        np.testing.assert_allclose(got[path], w, rtol=0, atol=rtol * scale, err_msg=str(path))


def assert_trajectories_match(got, want, start, lr, steps, far=FAR, share=1e-3, rtol_stats=1e-4):
    """Two runs of ``steps`` Adam steps at ``lr`` from the variables
    ``start``, held by ``hcunet_tpu_torch.train.parity.trajectory_gaps``
    (the rule ``chip_smoke.py`` holds K1's training runs to): every
    parameter within Adam's step bound, at most ``share`` of each
    parameter tensor's elements more than ``far`` lr apart (the
    BN-cancelled biases, whose gradient is 0 up to rounding, by the bound
    alone), the running statistics within ``rtol_stats`` of their scale
    (the running means, which take 0.1 of those biases a step, plus the
    bound)."""
    for (kind, path), gap in trajectory_gaps(got, want, start, lr, steps, far).items():
        assert gap <= (share if kind == "share" else rtol_stats), (kind, path, gap)


# --- multi-device -------------------------------------------------------------


def mesh_pair(axis_sizes):
    """``(port mesh, JAX mesh)`` with the same named axes: the port's over
    ``["cpu"] * n`` (one device repeated, in one process), JAX's over the
    first ``n`` of the 8 virtual CPU devices ``tests/conftest.py`` makes."""
    from hcunet_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from hcunet_tpu_torch.parallel.mesh import make_mesh

    n = int(np.prod(list(axis_sizes.values())))
    return make_mesh(dict(axis_sizes), ["cpu"] * n), jax_make_mesh(dict(axis_sizes), jax.devices()[:n])


@pytest.fixture(scope="module")
def spatial8():
    """The 8-way ``spatial`` mesh pair (:func:`mesh_pair`), once per module."""
    return mesh_pair({"spatial": 8})


@pytest.fixture(scope="module")
def multichip8():
    """The data 2 × model 2 × spatial 2 mesh pair of
    ``default_multichip_mesh(8)``, once per module."""
    return mesh_pair({"data": 2, "model": 2, "spatial": 2})
