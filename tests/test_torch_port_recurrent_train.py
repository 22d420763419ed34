"""Training of the recurrent family in the PyTorch port against the JAX
package, on the CPU, on the same weights and numpy inputs: the
RecursiveUNet's train-mode forward (batch statistics per timestep, the
running statistics carried through the timesteps as the JAX ``nn.scan``
carries ``batch_stats``), RDCNet's train mode, ``RecurrentTrainer`` (one
step's loss and gradients, 3-step Adam trajectories) and its checkpoints
across packages.

Tolerances: float32 on both sides, summed in other orders by XLA's and
PyTorch's CPU convs: the forward within 1e-5 of the output's scale, the
running statistics within 1e-6, the loss within 1e-5 relative and each
gradient within 1e-4 of its tensor's scale; trajectories as
``assert_trajectories_match`` holds them (``train/parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcunet_tpu.train.losses import cross_entropy as jax_cross_entropy
from hcunet_tpu.train.losses import mse_loss as jax_mse_loss
from hcunet_tpu.train.trainer import RecurrentTrainer as JaxRecurrentTrainer
from hcunet_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hcunet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig
from hcunet_tpu_torch.utils import port_jax
from hcunet_tpu_torch.utils.checkpoint import load_checkpoint, recurrent_model
from tests.test_torch_port_recurrent import jax_recurrent
from tests.torch_port_support import assert_grads_match, assert_trajectories_match, flat

SPATIAL = (16, 16, 4)
RUNET = dict(channels=(4, 8, 8), timesteps=2)
RDCNET = dict(complexity=2, timesteps=2)
FAMILIES = {"runet": RUNET, "rdcnet": RDCNET}


def sample(seed=0, spatial=SPATIAL):
    """``(image, mask, pwl, com, vec)``, a RecursiveStack sample's layout."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, *spatial, 4)).astype(np.float32)
    mask = (rng.random((1, *spatial, 1)) > 0.6).astype(np.float32)
    pwl = (rng.random((1, *spatial, 1)) + 0.5).astype(np.float32)
    com = rng.random((1, *spatial, 1)).astype(np.float32)
    vec = (rng.standard_normal((1, *spatial, 3)) * 0.3).astype(np.float32)
    return img, mask, pwl, com, vec


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    name = request.param
    return (name, *jax_recurrent(name, SPATIAL, **FAMILIES[name]))


def start_of(variables):
    """The trainers' ``variables`` form of a start: RDCNet's empty
    ``batch_stats`` too."""
    return {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}


def _jax_loss_and_grads(jmodel, variables, batch):
    img, mask, pwl, _com, vec = (jnp.asarray(a) for a in batch)
    stats = variables.get("batch_stats")

    def loss_fn(p):
        if stats:
            out, upd = jmodel.apply({"params": p, "batch_stats": stats}, img,
                                    train=True, mutable=["batch_stats"])
            new = upd["batch_stats"]
        else:
            out, new = jmodel.apply({"params": p}, img), {}
        loss = jax_cross_entropy(out[..., 0:1], mask, pwl, method="pixel")
        return loss + jax_mse_loss(out[..., 2:5], vec), new

    (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new)


def test_runet_train_forward_matches_jax():
    """Two timesteps in training mode against ``apply(train=True,
    mutable=["batch_stats"])``: each timestep normalizes with its own
    batch's statistics, and the running statistics take both updates in
    sequence (one timestep, or eval-mode BN, cannot show this)."""
    model, jmodel, variables = jax_recurrent("runet", SPATIAL, **RUNET)
    x = sample()[0]
    want, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want = np.asarray(want)
    got = model.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    stats = flat(port_jax.jax_variables_from_runet_state_dict(model.state_dict())["batch_stats"])
    want_stats = flat(jax.tree.map(np.asarray, upd["batch_stats"]))
    assert stats.keys() == want_stats.keys()
    start = flat(variables["batch_stats"])
    for path, w in want_stats.items():
        np.testing.assert_allclose(stats[path], w, rtol=0, atol=1e-6, err_msg=str(path))
        assert not np.array_equal(w, start[path]), path
    # the eval-mode forward is the model's serving forward, untouched
    with torch.no_grad():
        eval_out = model.eval()(torch.from_numpy(x)).numpy()
    assert not np.allclose(eval_out, got, atol=1e-3)


def test_rdcnet_train_mode_is_eval_mode_with_gradients():
    """RDCNet has no batch norm: its training forward equals its eval
    forward, and carries a gradient to every parameter."""
    model, _jm, _v = jax_recurrent("rdcnet", SPATIAL, **RDCNET)
    x = torch.from_numpy(sample()[0])
    with torch.no_grad():
        want = model.eval()(x)
    got = model.train()(x)
    assert torch.equal(got.detach(), want)
    got.square().mean().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in model.parameters())


def test_recurrent_trainer_step_matches_jax(family):
    """One ``RecurrentTrainer`` step against the JAX ``RecurrentTrainer``'s
    loss function and optax Adam (the JAX trainer itself is held by the
    trajectory test): the loss, every gradient, and the parameters and
    running statistics after the step."""
    name, _model, jmodel, variables = family
    batch = sample(1)
    lr = 1e-3
    loss_j, grads_j, stats_j = _jax_loss_and_grads(jmodel, variables, batch)
    tx = optax.adam(lr)
    updates, _ = tx.update(grads_j, tx.init(variables["params"]))
    want = {"params": jax.tree.map(np.asarray, optax.apply_updates(variables["params"], updates)),
            "batch_stats": stats_j}
    model = jax_recurrent(name, SPATIAL, **FAMILIES[name])[0]
    pt = RecurrentTrainer(model, cfg=TrainConfig(learning_rate=lr, log_every=0), device="cpu")
    loss_p = pt.train_step(*batch[:3], batch[4])
    assert abs(loss_p - loss_j) <= 1e-5 * loss_j, (loss_p, loss_j)
    grads_p = pt._jax_from_state_dict({n: p.grad for n, p in model.named_parameters()})["params"]
    assert_grads_match(grads_p, grads_j, rtol=1e-4)
    assert set(pt.variables) == set(want) == {"params", "batch_stats"}
    assert_trajectories_match(pt.variables, want, start_of(variables), lr, 1)


def test_recurrent_trainer_trajectory_matches_jax(family):
    """3 Adam steps on 3 samples (``fit`` for one epoch on each side):
    the summed loss, and the variables after the steps."""
    name, _model, jmodel, variables = family
    lr = 2e-3
    ds = [sample(s) for s in range(3)]
    jt = JaxRecurrentTrainer(jmodel, dict(variables), JaxTrainConfig(learning_rate=lr, log_every=0))
    pt = RecurrentTrainer(jax_recurrent(name, SPATIAL, **FAMILIES[name])[0],
                          cfg=TrainConfig(learning_rate=lr, log_every=0), device="cpu")
    (lj,), (lp,) = jt.fit(ds, epochs=1), pt.fit(ds, epochs=1)
    assert abs(lp - lj) <= 1e-5 * lj, (lp, lj)
    assert [m["epoch"] for m in pt.metrics.history] == [0]
    want = jax.tree.map(np.asarray, jt.variables)
    assert_trajectories_match(pt.variables, want, start_of(variables), lr, 3)


def test_recurrent_checkpoint_round_trip(family, tmp_path):
    """``RecurrentTrainer.save`` → the JAX package's ``load_checkpoint``
    (the same tree and config) → the port's ``recurrent_model``, whose
    weights equal the trainer's; the optimizer state crosses as the JAX
    chain's."""
    name, _model, jmodel, variables = family
    model = jax_recurrent(name, SPATIAL, **FAMILIES[name])[0]
    pt = RecurrentTrainer(model, cfg=TrainConfig(learning_rate=1e-3, log_every=0), device="cpu")
    pt.train_step(*sample(2)[:3], sample(2)[4])
    path = str(tmp_path / f"{name}.hcunet")
    pt.save(path)
    jcfg, jvars, hyper = jax_load_checkpoint(path)
    assert type(jcfg).__name__ == type(jmodel.config).__name__
    assert jcfg == type(jmodel.config)(**FAMILIES[name])
    assert hyper["learning_rate"] == 1e-3
    got, want = flat(jvars), flat(pt.variables)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    jmodel.apply(jax.tree.map(jnp.asarray, jvars), jnp.asarray(sample()[0]))  # the JAX model takes it
    config, cvars, _ = load_checkpoint(path)
    back = recurrent_model(config, cvars, device="cpu")
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], v), k
    opt = pt.opt_state
    assert set(opt) == {"0", "1"} and int(opt["0"]["count"]) == 1
    assert flat(opt["0"]["mu"]).keys() == flat(pt.variables["params"]).keys()


def test_recurrent_trainer_mesh_not_ported_and_device_explicit(monkeypatch):
    model = jax_recurrent("rdcnet", SPATIAL, **RDCNET)[0]
    with pytest.raises(TypeError, match="mesh"):
        RecurrentTrainer(model, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="RecursiveUNet or RDCNet"):
        from hcunet_tpu_torch.models.unet import UNet
        from hcunet_tpu_torch.config import UNetConfig

        RecurrentTrainer(UNet(UNetConfig()), {"params": {}}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecurrentTrainer(model)
