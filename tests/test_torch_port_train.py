"""The port's training (conv gradients through K1's autograd Function,
train-mode batch norm, ``UNetTrainer``) against the JAX package, on the CPU,
on the same weights and numpy inputs.

Tolerances: float32 on both sides, summed in other orders by XLA's and
PyTorch's CPU convs, so values within 1e-5 and gradients within 1e-4 of
their tensor's scale.  After Adam steps, trajectories are held as
``assert_trajectories_match`` says (Adam turns a near-zero gradient's
rounding difference into a whole step of lr).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.ops.conv import conv_valid as jax_conv_valid
from hcunet_tpu.train.losses import cross_entropy as jax_cross_entropy
from hcunet_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hcunet_tpu.train.trainer import UNetTrainer as JaxUNetTrainer
from hcunet_tpu_torch.ops.conv import (
    CONV3D_VALID,
    Conv3dValidFunction,
    batch_norm_train,
    conv3d_valid,
    conv3d_valid_input_grad,
    conv3d_valid_plain,
    conv3d_valid_weight_grad,
    conv_valid,
)
from hcunet_tpu_torch.train.parity import ADAM_STEP_BOUND, MAX_STEPS, trajectory_gaps
from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer
from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict
from tests.torch_port_support import (
    SMALL,
    SMALL_G2,
    TRAIN_SPATIAL,
    assert_grads_match,
    assert_trajectories_match,
    bn_cancelled,
    flat,
    jax_unet,
    port_unet,
    train_batch,
)

# (spatial dims, groups, dilation)
CONV_CASES = [(3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 2, 2), (2, 1, 1), (2, 2, 2)]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[0]}d-g{c[1]}-d{c[2]}")
def test_conv_valid_gradients_match_jax(case):
    """``conv_valid``'s gradients with respect to x, w and b (through the
    Function and, for groups = 2, the dense block-diagonal weight) against
    ``jax.grad`` of the JAX ``conv_valid``, for sum(out * r)."""
    nd, groups, dil = case
    rng = np.random.default_rng(nd * 10 + groups + dil)
    spatial = (11, 10, 7)[:nd]
    k = (3, 3, 2)[:nd]
    x = rng.standard_normal((2, *spatial, 8)).astype(np.float32)
    w = (rng.standard_normal((*k, 8 // groups, 6)) / 6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    out_sp = [s - dil * (kk - 1) for s, kk in zip(spatial, k)]
    r = rng.standard_normal((2, *out_sp, 6)).astype(np.float32)

    def jloss(x, w, b):
        return jnp.sum(jax_conv_valid(x, w, b, dilation=dil, groups=groups) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    (conv_valid(xt, wt, bt, dilation=dil, groups=groups) * torch.from_numpy(r)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv3d_function_matches_plain_autograd(dilation):
    """The Function's input gradient (the padded, flipped valid conv) and
    weight gradient against plain PyTorch autograd through the plain
    version, and the first layer's input gradient skipped."""
    rng = np.random.default_rng(dilation)
    x = torch.from_numpy(rng.standard_normal((2, 12, 11, 8, 5)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 2, 5, 7)) / 9).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 12 - 2 * dilation, 11 - 2 * dilation, 8 - dilation, 7)).astype(np.float32))
    grads = []
    for fn in (lambda a, b: Conv3dValidFunction.apply(a, b, (dilation,) * 3),
               lambda a, b: conv3d_valid_plain(a, b, dilation=dilation)):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xa, wa) * r).sum().backward()
        grads.append((xa.grad, wa.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(
        conv3d_valid_input_grad(r, w, dilation).numpy(), grads[1][0].numpy(),
        rtol=0, atol=1e-5 * float(grads[1][0].abs().max()),
    )
    np.testing.assert_allclose(
        conv3d_valid_weight_grad(x, r, w.shape, dilation).numpy(), grads[1][1].numpy(),
        rtol=0, atol=1e-5 * float(grads[1][1].abs().max()),
    )
    wa = w.clone().requires_grad_()
    out = Conv3dValidFunction.apply(x, wa, (dilation,) * 3)
    assert out.grad_fn.next_functions[0][0] is None  # x needs no gradient
    (out * r).sum().backward()
    assert wa.grad is not None


def test_conv3d_valid_gradient_never_lost():
    """An input that needs a gradient goes through the Function, or the
    call raises: with a bias or ReLU (the serving path's epilogue, which
    has no gradient path) it raises on every device, so that no output comes
    back without its gradient; under ``no_grad`` the serving call runs."""
    x = torch.zeros((1, 5, 5, 4, 3))
    w = torch.zeros((3, 3, 2, 3, 8), requires_grad=True)
    b = torch.zeros(8)
    assert conv3d_valid(x, w).grad_fn is not None
    for kw in (dict(bias=b), dict(relu=True)):
        with pytest.raises(ValueError, match="gradient path"):
            conv3d_valid(x, w, **kw)
    with torch.no_grad():
        assert conv3d_valid(x, w, b, True).grad_fn is None
    assert conv3d_valid(x, w.detach(), b, True).grad_fn is None
    before = CONV3D_VALID.launches
    conv3d_valid(x, w).sum().backward()
    assert CONV3D_VALID.launches == before  # the plain version on the CPU


@pytest.mark.parametrize("nd", [3, 2])
def test_batch_norm_train_matches_flax(nd):
    """Train-mode BN forward, its gradients (through the batch statistics)
    and the running update against flax ``nn.BatchNorm(momentum=0.9)``."""
    rng = np.random.default_rng(nd)
    x = (rng.standard_normal((2, 9, 8, 5, 6)[: nd + 1] + (6,)) * 3 + 1).astype(np.float32)
    scale = (rng.random(6) + 0.5).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    ra_mean, ra_var = rng.standard_normal(6).astype(np.float32), (rng.random(6) + 0.5).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}

    def jloss(x, s, b):
        y, upd = bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (y_want, new_stats)), g_want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    y, mean, var = batch_norm_train(xt, st, bt)
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), rtol=0, atol=1e-5)
    for got, want in zip((xt.grad, st.grad, bt.grad), g_want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    new_mean = 0.9 * torch.from_numpy(ra_mean) + 0.1 * mean.detach()
    new_var = 0.9 * torch.from_numpy(ra_var) + 0.1 * var.detach()
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(new_stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(new_stats["var"]), rtol=1e-6, atol=1e-6)


def _jax_loss_and_grads(jmodel, variables, batch, method="pixel"):
    img, mask, pwl = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        out, upd = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, img,
                                train=True, mutable=["batch_stats"])
        return jax_cross_entropy(out, mask, pwl, method=method), upd["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats)


def _port_grads(model):
    sd = {n: p.grad for n, p in model.named_parameters()}
    return jax_variables_from_unet_state_dict(sd, model.config)["params"]


@pytest.fixture(scope="module")
def unet_g2():
    return jax_unet(SMALL_G2, TRAIN_SPATIAL)


def test_unet_trainer_step_matches_jax(unet_g2):
    """One ``UNetTrainer`` step of the two-level net with groups = 2 against
    the JAX ``UNetTrainer``: the loss, every gradient, the new parameters
    and the new batch statistics."""
    cfg, jmodel, variables = unet_g2
    batch = train_batch()
    lr = 1e-3
    loss_j, grads_j, _ = _jax_loss_and_grads(jmodel, variables, batch)
    jt = JaxUNetTrainer(jmodel, variables, JaxTrainConfig(learning_rate=lr, log_every=0))
    assert abs(jt.train_step(*batch) - loss_j) <= 1e-6 * loss_j
    want = jax.tree.map(np.asarray, jt.variables)

    model = port_unet(cfg, variables)
    pt = UNetTrainer(model, cfg=TrainConfig(learning_rate=lr, log_every=0), device="cpu")
    loss_p = pt.train_step(*batch)
    assert abs(loss_p - loss_j) <= 1e-5 * loss_j, (loss_p, loss_j)
    assert_grads_match(_port_grads(model), grads_j, rtol=1e-4)
    assert_trajectories_match(pt.variables, want, variables, lr, 1)


@pytest.mark.parametrize("tx", ["adam", "adamw_gamma"])
def test_unet_trainer_trajectory_matches_jax(unet_g2, tx):
    """5 steps, with Adam and with AdamW plus a per-epoch ``gamma`` decay
    (2 steps an epoch, so the rate drops twice), against the JAX trainer:
    the losses step by step and the variables at the end."""
    cfg, jmodel, variables = unet_g2
    kw = dict(learning_rate=2e-3, log_every=0)
    if tx == "adamw_gamma":
        kw.update(weight_decay=0.05, gamma=0.5, steps_per_epoch=2)
    batches = [train_batch(seed) for seed in range(5)]
    jt = JaxUNetTrainer(jmodel, variables, JaxTrainConfig(**kw))
    pt = UNetTrainer(port_unet(cfg, variables), cfg=TrainConfig(**kw), device="cpu")
    for b in batches:
        lj, lp = jt.train_step(*b), pt.train_step(*b)
        assert abs(lp - lj) <= 1e-5 * lj, (lp, lj)
    assert_trajectories_match(pt.variables, jax.tree.map(np.asarray, jt.variables), variables,
                              kw["learning_rate"], 5)
    if tx == "adamw_gamma":
        assert pt.opt.param_groups[0]["lr"] == pytest.approx(2e-3 * 0.5 ** 2)


def test_unet_trainer_bf16_step_matches_jax():
    """One bf16 step (``UNet(dtype=bfloat16)``, float32 parameters and
    Adam) against the JAX trainer in bf16.  Both round every conv and batch
    norm output to bf16 at the same places; tolerances follow the F1
    pattern of ``test_torch_port_bf16.py``: the loss within 1 %, and each
    gradient's port-vs-JAX gap (norm of the difference over the norm) below
    0.5 and below 2x the larger of the two sides' own bf16-vs-float32 gaps,
    which themselves agree within 4x (a port that rounded elsewhere would
    move its gap away from JAX's).  One exception: ``out_bias``'s gradient
    is the sum of the bf16 output gradient over every voxel, which XLA on
    the CPU accumulates in bf16 (its own gap 17 %) and PyTorch in float32
    (0.2 %); it is held to the JAX float32 gradient within the JAX bf16
    gap instead."""
    cfg, _jm, variables = jax_unet(SMALL_G2, TRAIN_SPATIAL)
    from hcunet_tpu.models.unet import UNet as JaxUNet
    from hcunet_tpu.config import UNetConfig as JaxUNetConfig

    batch = train_batch()
    grads, losses = {}, {}
    for name, (jdt, tdt) in {"f32": (jnp.float32, torch.float32),
                             "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        jmodel = JaxUNet(JaxUNetConfig(**SMALL_G2), dtype=jdt)
        losses["jax", name], grads["jax", name], _ = _jax_loss_and_grads(jmodel, variables, batch)
        model = port_unet(cfg, variables)
        model.dtype = tdt
        pt = UNetTrainer(model, cfg=TrainConfig(learning_rate=1e-3, log_every=0), device="cpu")
        losses["port", name] = pt.train_step(*batch)
        grads["port", name] = _port_grads(model)
    assert abs(losses["port", "bf16"] - losses["jax", "bf16"]) <= 1e-2 * losses["jax", "f32"]
    flats = {k: flat(v) for k, v in grads.items()}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    for path, ref in flats["jax", "f32"].items():
        if bn_cancelled(path):
            continue  # 0 up to rounding on every side
        gap = rel(flats["port", "bf16"][path], flats["jax", "bf16"][path])
        own_j = rel(flats["jax", "bf16"][path], ref)
        own_p = rel(flats["port", "bf16"][path], flats["port", "f32"][path])
        if path == ("out_bias",):
            assert rel(flats["port", "bf16"][path], ref) <= own_j, (path, own_p, own_j)
            continue
        assert gap <= 0.5 and gap <= 2 * max(own_j, own_p), (path, gap, own_j, own_p)
        assert 0.25 <= (own_p + 1e-6) / (own_j + 1e-6) <= 4.0, (path, own_p, own_j)


def test_unet_trainer_loss_decreases():
    """The port's mirror of ``tests/test_train_and_targets.py::
    test_unet_trainer_loss_decreases``: 8 epochs of one sample, on a model
    from the port's own ``init_unet``."""
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.models.unet import init_unet

    cfg = UNetConfig(**SMALL)
    model = init_unet(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    img = rng.random((1, 32, 32, 6, 4)).astype(np.float32)
    mask = (rng.random((1, 32, 32, 6, 1)) > 0.7).astype(np.float32)
    trainer = UNetTrainer(model, cfg=TrainConfig(learning_rate=1e-2, log_every=0), device="cpu")
    losses = trainer.fit([(img, mask, np.ones_like(mask))], epochs=8)
    assert losses[-1] < losses[0]
    assert [m["epoch"] for m in trainer.metrics.history] == list(range(8))


def test_unet_trainer_mesh_not_ported_and_device_explicit(monkeypatch):
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.models.unet import init_unet

    model = init_unet(UNetConfig(**SMALL), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mesh"):
        UNetTrainer(model, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNetTrainer(model)


def test_rng_streams_and_named_generators():
    """``core/rng.py``: ``fold_in_str`` hashes a name as the JAX twin does
    (the JAX ``fold_in_str`` equals ``jax.random.fold_in`` by the port's
    hash), its generator depends on the parent's seed and the name only,
    and ``key_stream`` gives distinct, reproducible generators."""
    from hcunet_tpu.core.rng import fold_in_str as jax_fold_in_str
    from hcunet_tpu_torch.core import rng as trng

    key = jax.random.PRNGKey(3)
    for name in ("augment", "dropout", "a" * 40):
        want = jax_fold_in_str(key, name)
        assert np.array_equal(np.asarray(jax.random.fold_in(key, trng._fold_hash(name))), np.asarray(want))

    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    torch.rand(5, generator=g2)  # a parent drawn from: the named child does not move
    a, b = trng.fold_in_str(g1, "augment"), trng.fold_in_str(g2, "augment")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    other = trng.fold_in_str(g1, "dropout")
    assert not torch.equal(torch.rand(4, generator=other),
                           torch.rand(4, generator=trng.fold_in_str(g1, "augment")))
    s1 = trng.key_stream(torch.Generator().manual_seed(2))
    s2 = trng.key_stream(torch.Generator().manual_seed(2))
    draws1 = [torch.rand(3, generator=next(s1)) for _ in range(3)]
    draws2 = [torch.rand(3, generator=next(s2)) for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(draws1, draws2))
    assert not torch.equal(draws1[0], draws1[1])


def test_adam_step_bound_holds_and_is_enforced():
    """``ADAM_STEP_BOUND``: the Cauchy-Schwarz bound on lr |m_hat| /
    sqrt(v_hat) at (0.9, 0.999), doubled and summed over the steps, stays
    within the constant for up to ``MAX_STEPS`` steps; and
    ``trajectory_gaps`` raises when a parameter parts by more."""
    b1, b2 = 0.9, 0.999
    total = 0.0
    for t in range(1, MAX_STEPS + 1):
        i = np.arange(1, t + 1)
        a = (1 - b1) * b1 ** (t - i) / (1 - b1**t)
        b = (1 - b2) * b2 ** (t - i) / (1 - b2**t)
        total += 2 * np.sqrt((a * a / b).sum())
        assert total <= ADAM_STEP_BOUND * t, (t, total)
    start = {"params": {"w": np.zeros(8)}, "batch_stats": {}}
    want = {"params": {"w": np.full(8, 0.1)}, "batch_stats": {}}
    got = {"params": {"w": np.full(8, 0.1) + np.eye(8)[0] * ADAM_STEP_BOUND * 1e-3 * 0.99}, "batch_stats": {}}
    assert trajectory_gaps(got, want, start, 1e-3, 1) == {("share", ("w",)): 0.125}
    got["params"]["w"][0] += ADAM_STEP_BOUND * 1e-3 * 0.02
    with pytest.raises(AssertionError, match="step bound"):
        trajectory_gaps(got, want, start, 1e-3, 1)
    with pytest.raises(ValueError):
        trajectory_gaps(want, want, start, 1e-3, MAX_STEPS + 1)
