"""Data- and model-parallel training of the PyTorch port
(``hcunet_tpu_torch.parallel.train``, ``UNetTrainer(mesh=)``,
``RecurrentTrainer(mesh=)``) against the port's single-device trainer on
the global batch and against the JAX package's mesh trainers, case for case
with ``tests/test_parallel.py``, on the data 2 × model 2 × spatial 2 mesh
pair of ``tests/torch_port_support.py`` (a data-2 mesh for the recurrent
family).

Tolerances: the losses within 1e-4 relative (1e-5 for a resume against the
uninterrupted run), as the JAX tests hold their mesh trainers; the
variables after the steps as ``assert_trajectories_match`` holds them
(``train/parity.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcunet_tpu.parallel.train import make_sharded_train_step as jax_make_sharded_train_step
from hcunet_tpu.parallel.train import make_unet_loss_fn as jax_make_unet_loss_fn
from hcunet_tpu.train.losses import cross_entropy as jax_cross_entropy
from hcunet_tpu.train.trainer import RecurrentTrainer as JaxRecurrentTrainer
from hcunet_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hcunet_tpu.train.trainer import UNetTrainer as JaxUNetTrainer
from hcunet_tpu_torch.parallel.train import make_sharded_train_step, make_unet_loss_fn
from hcunet_tpu_torch.train.losses import cross_entropy
from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig, UNetTrainer
from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict
from tests.test_torch_port_recurrent import jax_recurrent
from tests.test_torch_port_recurrent_train import sample, start_of
from tests.torch_port_support import (  # noqa: F401
    SMALL,
    assert_trajectories_match,
    jax_unet,
    mesh_pair,
    multichip8,
    one_thread,
    port_unet,
)

SPATIAL = (48, 48, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def unet():
    cfg, jmodel, variables = jax_unet(SMALL, SPATIAL)
    return cfg, jmodel, variables


def batches(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((size, *SPATIAL, 4), np.float32),
         (rng.random((size, *SPATIAL, 1)) > 0.7).astype(np.float32),
         np.ones((size, *SPATIAL, 1), np.float32))
        for _ in range(n)
    ]


def test_port_sharded_train_step_matches_single_and_jax(unet, multichip8):
    """``make_sharded_train_step`` on the 2 × 2 × 2 mesh, with every
    parameter of at least 8 channels sliced over ``model`` (the JAX side
    keeps its default 32, which slices none: the slices' arithmetic is the
    whole tensors'), tracks the single-device step on the global batch of
    4 and the JAX sharded step over 3 steps."""
    cfg, jmodel, variables = unet
    port_mesh, jax_mesh = multichip8
    (batch,) = batches(1, 4)
    model = port_unet(cfg, variables)
    init_fn, step_fn = make_sharded_train_step(
        make_unet_loss_fn(model, lambda out, mask, pwl: cross_entropy(out, mask, pwl)),
        lambda leaves: (torch.optim.Adam(leaves, lr=1e-3), None),
        port_mesh, lambda sd: jax_variables_from_unet_state_dict(sd, cfg), min_size=8,
    )
    state = init_fn()
    assert sum(d is not None for d in state.params.split.values()) > 0
    got = []
    for _ in range(3):
        state, loss = step_fn(state, batch)
        got.append(loss)
    assert state.step == 3

    single = UNetTrainer(port_unet(cfg, variables), None, TrainConfig(learning_rate=1e-3),
                         device="cpu")
    np.testing.assert_allclose(got, [single.train_step(*batch) for _ in range(3)], rtol=1e-4)

    tx = optax.adam(1e-3)
    jinit, jstep = jax_make_sharded_train_step(
        jax_make_unet_loss_fn(jmodel, lambda out, mask, pwl: jax_cross_entropy(out, mask, pwl)),
        tx, jax_mesh, variables["params"],
    )
    jstate = jinit(variables["params"], variables["batch_stats"])
    want = []
    for _ in range(3):
        jstate, loss = jstep(jstate, tuple(jnp.asarray(a) for a in batch))
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_port_unet_trainer_mesh_matches_single_device(unet, multichip8):
    """``UNetTrainer(mesh=)`` groups ``data_size`` samples per step and
    tracks the single-device trainer on the same global batches and the
    JAX mesh trainer; its variables (the slices gathered) follow the
    single-device trajectory."""
    cfg, jmodel, variables = unet
    port_mesh, jax_mesh = multichip8
    tcfg = dict(learning_rate=1e-3, loss_method="pixel")
    tr_mesh = UNetTrainer(port_unet(cfg, variables), None, TrainConfig(**tcfg), mesh=port_mesh)
    assert tr_mesh.data_size == 2 and tr_mesh.device == torch.device("cpu")
    tr_single = UNetTrainer(port_unet(cfg, variables), None, TrainConfig(**tcfg), device="cpu")
    ds = batches(5, 1, seed=1)
    groups = list(tr_mesh._iter_batches(ds))
    assert len(groups) == 3 and groups[-1][0].shape[0] == 2
    np.testing.assert_array_equal(groups[-1][0][1], ds[0][0][0])  # wrapped
    got = [tr_mesh.train_step(*b) for b in groups]
    np.testing.assert_allclose(got, [tr_single.train_step(*b) for b in groups], rtol=1e-4)
    assert_trajectories_match(tr_mesh.variables, tr_single.variables, variables, 1e-3, 3)

    jt = JaxUNetTrainer(jmodel, dict(variables), JaxTrainConfig(**tcfg), mesh=jax_mesh)
    want = [jt.train_step(*(jnp.asarray(a) for a in b)) for b in groups]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_port_unet_trainer_mesh_resume_matches_uninterrupted(unet, multichip8, tmp_path):
    """A training state saved under the mesh (the ``model``-axis slices and
    their Adam moments gathered) and restored into a fresh mesh trainer (put
    back as slices on their devices) continues the uninterrupted run; the
    file is the JAX trainer's format, and the JAX trainer resumes it too."""
    cfg, jmodel, variables = unet
    port_mesh, _jax_mesh = multichip8
    tcfg = dict(learning_rate=1e-2, log_every=0)
    data = batches(5, 2, seed=2)

    def mesh_trainer():
        tr = UNetTrainer(port_unet(cfg, variables), None, TrainConfig(**tcfg), mesh=port_mesh)
        # slice every parameter of at least 8 channels over ``model``
        from hcunet_tpu_torch.parallel.train import DataModelParallel

        tr._sharded = DataModelParallel(tr.model, port_mesh,
                                        tr._jax_from_state_dict, min_size=8)
        tr.opt, tr.schedule = torch.optim.Adam(tr._sharded.params.leaves(), lr=1e-2), None
        return tr

    tr = mesh_trainer()
    for b in data[:3]:
        tr.train_step(*b)
    path = str(tmp_path / "mesh_state.bin")
    tr.save_training_state(path)
    ref = [tr.train_step(*b) for b in data[3:]]

    tr2 = mesh_trainer()
    tr2.load_training_state(path)
    sliced = [t for t in tr2._sharded.params.leaves() if t not in set(tr2.model.parameters())]
    assert sliced and all(tr2.opt.state[t]["exp_avg"].shape == t.shape for t in sliced)
    np.testing.assert_allclose([tr2.train_step(*b) for b in data[3:]], ref, rtol=1e-5)

    jt = JaxUNetTrainer(jmodel, dict(variables), JaxTrainConfig(**tcfg))
    jt.load_training_state(path)
    np.testing.assert_allclose([jt.train_step(*(jnp.asarray(a) for a in b)) for b in data[3:]],
                               ref, rtol=1e-4)


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_port_recurrent_trainer_mesh_matches_single_device(family):
    """``RecurrentTrainer(mesh=)`` on a data-2 mesh: the RecursiveUNet's
    batch norm on global-batch statistics every timestep, RDCNet without
    batch norm; against the single-device trainer on the global batch and
    the JAX ``RecurrentTrainer(mesh=)``, 3 steps."""
    from tests.test_torch_port_recurrent_train import FAMILIES, SPATIAL as RSPATIAL

    model, jmodel, variables = jax_recurrent(family, RSPATIAL, **FAMILIES[family])
    port_mesh, jax_mesh = mesh_pair({"data": 2})
    steps = [tuple(np.concatenate(p) for p in zip(sample(2 * i), sample(2 * i + 1)))
             for i in range(3)]
    tr_mesh = RecurrentTrainer(copy.deepcopy(model), None, TrainConfig(learning_rate=1e-3),
                               mesh=port_mesh)
    tr_single = RecurrentTrainer(copy.deepcopy(model), None, TrainConfig(learning_rate=1e-3),
                                 device="cpu")
    got = [tr_mesh.train_step(img, mask, pwl, vec) for img, mask, pwl, _c, vec in steps]
    want = [tr_single.train_step(img, mask, pwl, vec) for img, mask, pwl, _c, vec in steps]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_trajectories_match(tr_mesh.variables, tr_single.variables, start_of(variables),
                              1e-3, 3)

    jt = JaxRecurrentTrainer(jmodel, dict(variables), JaxTrainConfig(learning_rate=1e-3),
                             mesh=jax_mesh)
    jl = [jt.train_step(img, mask, pwl, vec) for img, mask, pwl, _c, vec in steps]
    np.testing.assert_allclose(got, jl, rtol=1e-4)
