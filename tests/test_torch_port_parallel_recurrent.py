"""Recurrent serving over a mesh (``compile_recurrent_apply(mesh=)``,
``compile_rdcnet_apply(mesh=)``): one x-tile per entry of the port's 8-way
``spatial`` mesh, both carries' seams refreshed across devices every
timestep, against the port's ``split_x=8`` forward without a mesh and the
JAX package's mesh forward (``tests/test_parallel.py``'s geometry, 512 x 16
x 10 at 2 timesteps, float32).

Tolerances against the port's split forward (the same tiles, batched one
per device instead of eight on one): RDCNet within 1e-6; the RecursiveUNet
within 1e-5 of the output's scale, the CPU rule of the port's recurrent
split tests: the CPU's ``F.conv3d`` rounds by batch shape (6.6e-6 at a
scale of 0.47 here, with one torch thread or four), where the card's K1
computes each voxel alike at any batch size and ``chip_smoke.py`` holds the
two runs there.  Against JAX, 5e-5 (slice 10's float32 tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.infer import compile_recurrent as jcr
from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
from hcunet_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_port_recurrent import jax_recurrent
from tests.torch_port_support import spatial8  # noqa: F401

SPATIAL = (512, 16, 10)


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_port_recurrent_mesh_matches_single_device(spatial8, family):  # noqa: F811
    port_mesh, jax_mesh = spatial8
    model, jmodel, variables = jax_recurrent(family, (32, 32, 10), timesteps=2)
    x = np.random.default_rng(0).standard_normal((1, *SPATIAL, 4)).astype(np.float32)
    split = compile_recurrent_apply(model, dtype=torch.float32, device="cpu", split_x=8)
    mesh_fn = compile_recurrent_apply(model, dtype=torch.float32, split_x=8, mesh=port_mesh)
    got = mesh_fn(torch.from_numpy(x)).numpy()
    want = split(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *SPATIAL, 5)
    atol = 1e-5 * float(np.abs(want).max()) if family == "runet" else 1e-6
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)

    compile_jax = jcr.compile_recurrent_apply if family == "runet" else jcr.compile_rdcnet_apply
    jfn = jax.jit(compile_jax(jmodel, variables, dtype=jnp.float32, split_x=8, mesh=jax_mesh))
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))), atol=5e-5, rtol=0)


def test_port_recurrent_mesh_needs_whole_tiles_per_device():
    """``split_x`` must be a multiple of the mesh's size (the JAX
    ``tiles_sharding`` check); 16 tiles on 8 entries batch two on each."""
    model, _jm, _v = jax_recurrent("rdcnet", (32, 32, 10), timesteps=1)
    mesh = make_mesh({"spatial": 8}, ["cpu"] * 8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 512, 16, 10, 4),
                                                                   np.float32))
    with pytest.raises(ValueError, match="cannot shard evenly"):
        compile_recurrent_apply(model, dtype=torch.float32, split_x=4, mesh=mesh)(x)
    got = compile_recurrent_apply(model, dtype=torch.float32, split_x=16, mesh=mesh)(x)
    want = compile_recurrent_apply(model, dtype=torch.float32, device="cpu", split_x=16)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
