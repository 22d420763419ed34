"""Training engines (twin of ``hcunet_tpu/train/trainer.py``, single device).

:class:`UNetTrainer` fits a :class:`~hcunet_tpu_torch.models.unet.UNet` on
Stack-style ``(image, mask, pwl)`` samples with the pwl-weighted BCE (and
an optional dice term) and Adam, as the JAX trainer does: one step computes
the loss in training mode (batch statistics, and the running statistics
updated in the BN buffers, as flax's ``mutable=["batch_stats"]``), its
gradient (K1 for the forward and the input gradient of every valid conv on
CUDA), and one optimizer step.  Parameters and the optimizer stay float32;
the forward runs in the model's dtype.

The optimizer matches ``_make_tx``'s optax chain: ``torch.optim.Adam``, or
``AdamW`` (decay on every parameter, as ``optax.adamw``) when
``weight_decay`` is set; ``gamma`` is a staircase exponential decay of the
learning rate every ``steps_per_epoch`` steps.  optax reads the step count
before it increments it, so the schedule steps after the optimizer.

:class:`RecurrentTrainer` is the r-unet/RDCNet recipe
(``tests/r_unet_test.py:51-54`` of the reference): the pwl-BCE of the
probability channel ``out[..., 0:1]`` plus the MSE of the vector channels
``out[..., 2:5]``, on ``(image, mask, pwl, com, vec)`` samples, for a
:class:`~hcunet_tpu_torch.models.runet.RecursiveUNet` (train-mode batch norm
through every timestep) or an :class:`~hcunet_tpu_torch.models.rdcnet.RDCNet`;
each same-padding conv runs K1 forward and K1's input gradient on CUDA.

Checkpoints and training states use the JAX package's formats
(:mod:`hcunet_tpu_torch.utils.checkpoint`), so either package resumes the
other's.  Steps and fits run float32 with TF32 off
(:func:`~hcunet_tpu_torch.core.precision.exact_float32`).

With a ``mesh``, a step takes the global batch and runs it data- and
model-parallel (:class:`~hcunet_tpu_torch.parallel.train.DataModelParallel`):
the batch split over the ``data`` devices, batch norm on global-batch
statistics, the loss on the gathered output, large kernels as Cout slices
on the ``model`` devices.  ``fit`` groups ``data``-axis-size samples into
each global batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.train.losses import cross_entropy, dice, mse_loss
from hcunet_tpu_torch.utils.logging import Metrics, get_logger

log = get_logger(__name__)


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 100
    loss_method: str = "pixel"
    dice_weight: float = 0.0
    gamma: Optional[float] = None  # ExponentialLR-style per-EPOCH decay
    steps_per_epoch: int = 1  # converts gamma to a per-step schedule
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 1


def _make_tx(
    cfg: TrainConfig, params
) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """The optimizer and, with ``gamma``, its learning-rate schedule:
    ``lr * gamma ** (step // steps_per_epoch)``, as
    ``optax.exponential_decay(..., staircase=True)``."""
    if cfg.weight_decay:
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=cfg.learning_rate)
    if cfg.gamma is None:
        return opt, None
    every = max(cfg.steps_per_epoch, 1)
    gamma = cfg.gamma
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: gamma ** (step // every))


class UNetTrainer:
    def __init__(
        self,
        model,
        variables: Optional[Mapping] = None,
        cfg: TrainConfig = TrainConfig(),
        mesh=None,
        device=None,
    ):
        """``model``: the port's ``UNet``, trained in place (moved to
        ``device``, CUDA unless given).  ``variables``: the JAX
        ``{"params", "batch_stats"}`` tree or the port's state dict to start
        from; None keeps the model's own weights.

        ``mesh``: a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh`; steps
        then take global batches of ``data_size`` (the ``data`` axis's
        size) samples, run over it, and ``device`` is its first ``data``
        device."""
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self._sharded = None
        if variables is not None:
            if "params" in variables:
                variables = self._state_dict_from_jax(variables)
            model.load_state_dict(variables)
        if mesh is not None:
            from hcunet_tpu_torch.parallel.train import DataModelParallel

            self._sharded = DataModelParallel(model, mesh, self._jax_from_state_dict)
            device = self._sharded.home
        self.device = resolve_device(device)
        self.data_size = 1 if self._sharded is None else self._sharded.data_size
        model.to(self.device)
        leaves = model.parameters() if self._sharded is None else self._sharded.params.leaves()
        self.opt, self.schedule = _make_tx(cfg, leaves)
        self.metrics = Metrics()

    def _forward(self, image: torch.Tensor) -> torch.Tensor:
        """The model's training-mode output on the (global) batch."""
        self.model.train()
        return self.model(image) if self._sharded is None else self._sharded.forward(image)

    @exact_float32()
    def train_step(self, image, mask, pwl) -> float:
        """One step on a batch (channels-last numpy arrays or tensors; with
        a mesh, the global batch); returns the loss before the step."""
        cfg, dev = self.cfg, self.device
        image = torch.as_tensor(image, device=dev, dtype=torch.float32)
        mask = torch.as_tensor(mask, device=dev)
        pwl = None if pwl is None else torch.as_tensor(pwl, device=dev)
        out = self._forward(image)
        loss = cross_entropy(out, mask, pwl, method=cfg.loss_method)
        if cfg.dice_weight:
            loss = loss + cfg.dice_weight * dice(out, mask)
        return self._apply(loss)

    def _apply(self, loss: torch.Tensor) -> float:
        """Backpropagate ``loss``, step the optimizer and the schedule."""
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        if self.schedule is not None:
            self.schedule.step()
        return float(loss.detach())

    def _state_dict_from_jax(self, variables: Mapping) -> Dict:
        """The model's state dict from a JAX variable tree (or a tree of
        parameters alone, as an optimizer moment)."""
        from hcunet_tpu_torch.utils.port_jax import unet_state_dict_from_jax_variables

        return unet_state_dict_from_jax_variables(variables, self.model.config)

    def _jax_from_state_dict(self, sd: Mapping) -> Dict:
        """Inverse of :meth:`_state_dict_from_jax`."""
        from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict

        return jax_variables_from_unet_state_dict(sd, self.model.config)

    @property
    def variables(self) -> Dict:
        """The JAX ``{"params", "batch_stats"}`` tree of the model, as numpy
        (with a mesh, the ``model``-axis slices gathered)."""
        if self._sharded is not None:
            self._sharded.params.sync_model()
        return self._jax_from_state_dict(self.model.state_dict())

    @property
    def opt_state(self) -> Dict:
        """The optimizer state as the JAX trainer's optax state, in
        state-dict form (numpy leaves)."""
        from hcunet_tpu_torch.utils.port_jax import optax_adam_state_from_torch

        count = None if self.schedule is None else self.schedule.last_epoch
        opt = self.opt
        if self._sharded is not None:
            # the state of the model's own parameters, the slices' moments gathered
            opt = SimpleNamespace(state=self._sharded.params.gathered_state(self.opt))
        return optax_adam_state_from_torch(
            opt, self.model, lambda sd: self._jax_from_state_dict(sd)["params"],
            self.cfg.weight_decay, count,
        )

    def _iter_batches(self, dataset):
        """Yield global batches: the dataset's samples one by one on one
        device; with a mesh, groups of ``data_size`` samples stacked along
        the batch axis (wrapping to fill the last group, so that every step
        splits evenly)."""
        n = len(dataset)
        if self.data_size <= 1:
            for i in range(n):
                yield dataset[i]
            return
        for g0 in range(0, n, self.data_size):
            samples = [dataset[(g0 + k) % n] for k in range(self.data_size)]
            yield tuple(
                np.concatenate([np.asarray(s[j]) for s in samples], axis=0)
                for j in range(len(samples[0]))
            )

    @exact_float32()
    def fit(self, dataset, epochs: Optional[int] = None) -> List[float]:
        """``dataset``: indexable of ``(image, mask, pwl)`` channels-last
        batches.  Returns per-epoch summed losses (the reference trainer's
        console metric, ``train_fastercnn_func.py:51-62``)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        summed: List[float] = []
        for e in range(epochs):
            t0 = time.perf_counter()
            total = 0.0
            for image, mask, pwl in self._iter_batches(dataset):
                total += self.train_step(image, mask, pwl)
            summed.append(total)
            self.metrics.write(
                epoch=e, summed_loss=total,
                avg_loss=total / max(len(dataset), 1),
                epoch_seconds=time.perf_counter() - t0,
            )
            if cfg.log_every and e % cfg.log_every == 0:
                log.info(
                    "epoch %d | SL %.6f | AL %.6f | %.2fs",
                    e, total, total / max(len(dataset), 1),
                    time.perf_counter() - t0,
                )
            if (
                cfg.checkpoint_path
                and cfg.checkpoint_every
                and (e + 1) % cfg.checkpoint_every == 0
            ):
                self.save(cfg.checkpoint_path)
        return summed

    def save(self, path: str, config=None, hyperparameters: Optional[Dict] = None):
        """A checkpoint in the JAX package's zip format."""
        from hcunet_tpu_torch.utils.checkpoint import save_checkpoint

        cfg_obj = config if config is not None else self.model.config
        hp = dict(
            learning_rate=self.cfg.learning_rate,
            epochs=self.cfg.epochs,
            loss_method=self.cfg.loss_method,
        )
        hp.update(hyperparameters or {})
        save_checkpoint(path, self.variables, cfg_obj, hp)

    def save_training_state(self, path: str) -> None:
        """Full resume state, in the JAX trainer's format: the variables and
        the optimizer state (Adam moments and counts), flax-serialized."""
        from hcunet_tpu_torch.utils._flax_msgpack import to_bytes

        blob = to_bytes({"variables": self.variables, "opt_state": self.opt_state})
        with open(path, "wb") as f:
            f.write(blob)

    def load_training_state(self, path: str) -> None:
        """Resume from :meth:`save_training_state`'s file, or the JAX
        trainer's, for the same model and ``TrainConfig``."""
        from hcunet_tpu_torch.utils._flax_msgpack import msgpack_restore
        from hcunet_tpu_torch.utils.port_jax import torch_adam_state_from_optax

        with open(path, "rb") as f:
            state = msgpack_restore(f.read())
        want = 3 if self.cfg.weight_decay else 2
        if len(state["opt_state"]) != want:
            raise ValueError(
                f"the training state's optimizer chain has {len(state['opt_state'])} "
                f"entries; this TrainConfig's has {want}"
            )
        self.model.load_state_dict(self._state_dict_from_jax(state["variables"]))
        to_sd = lambda params: self._state_dict_from_jax({"params": params})  # noqa: E731
        if self._sharded is None:
            opt_sd, count = torch_adam_state_from_optax(state["opt_state"], self.opt, self.model,
                                                        to_sd)
            self.opt.load_state_dict(opt_sd)
        else:
            # whole moments through an optimizer over the model's own
            # parameters, then each slice's share onto its device
            whole = type(self.opt)(self.model.parameters())
            opt_sd, count = torch_adam_state_from_optax(state["opt_state"], whole, self.model,
                                                        to_sd)
            whole.load_state_dict(opt_sd)
            self._sharded.params.load_model()
            self.opt.state.clear()
            self._sharded.params.scatter_state(self.opt, whole.state)
        if (count is None) != (self.schedule is None):
            raise ValueError("the training state and this TrainConfig differ on gamma")
        if self.schedule is not None:
            self.schedule.last_epoch = count
            for group, base in zip(self.opt.param_groups, self.schedule.base_lrs):
                group["lr"] = base * self.schedule.lr_lambdas[0](count)



class RecurrentTrainer(UNetTrainer):
    """r-unet/RDCNet recipe: ``out[..., 0]`` is the probability channel
    trained with pwl-BCE; ``out[..., 2:5]`` are the vector channels trained
    with MSE (``tests/r_unet_test.py:51-54``).  ``model``: the port's
    ``RecursiveUNet`` or ``RDCNet``; ``variables``: the JAX tree of that
    model (``{"params", "batch_stats"}``, ``{"params"}`` for RDCNet) or its
    state dict."""

    def _family(self):
        from hcunet_tpu_torch.models.rdcnet import RDCNet
        from hcunet_tpu_torch.models.runet import RecursiveUNet
        from hcunet_tpu_torch.utils import port_jax

        if isinstance(self.model, RecursiveUNet):
            return (port_jax.runet_state_dict_from_jax_variables,
                    port_jax.jax_variables_from_runet_state_dict)
        if isinstance(self.model, RDCNet):
            return (port_jax.rdcnet_state_dict_from_jax_variables,
                    port_jax.jax_variables_from_rdcnet_state_dict)
        raise TypeError(f"RecurrentTrainer trains RecursiveUNet or RDCNet, not "
                        f"{type(self.model).__name__}")

    def _state_dict_from_jax(self, variables: Mapping) -> Dict:
        return self._family()[0](variables)

    def _jax_from_state_dict(self, sd: Mapping) -> Dict:
        tree = self._family()[1](sd)
        # the JAX trainer keeps an empty batch_stats for a model without BN
        return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}

    @exact_float32()
    def train_step(self, image, mask, pwl, vec) -> float:  # type: ignore[override]
        """One step on a batch (with a mesh, the global batch); returns the
        loss before the step."""
        cfg, dev = self.cfg, self.device
        image = torch.as_tensor(image, device=dev, dtype=torch.float32)
        mask = torch.as_tensor(mask, device=dev)
        pwl = None if pwl is None else torch.as_tensor(pwl, device=dev)
        vec = torch.as_tensor(vec, device=dev, dtype=torch.float32)
        out = self._forward(image)
        loss = cross_entropy(out[..., 0:1], mask, pwl, method=cfg.loss_method)
        loss = loss + mse_loss(out[..., 2:5], vec)
        return self._apply(loss)

    @exact_float32()
    def fit(self, dataset, epochs: Optional[int] = None) -> List[float]:  # type: ignore[override]
        """``dataset``: indexable of ``(image, mask, pwl, com, vec)``
        channels-last batches.  Returns per-epoch summed losses, as the JAX
        ``RecurrentTrainer.fit`` (no periodic checkpoint)."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        summed: List[float] = []
        for e in range(epochs):
            total = 0.0
            for image, mask, pwl, _com, vec in self._iter_batches(dataset):
                total += self.train_step(image, mask, pwl, vec)
            summed.append(total)
            self.metrics.write(epoch=e, summed_loss=total)
        return summed

