"""U-Net training (twin of ``hcunet_tpu/train/trainer.py``, single device).

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

Checkpoints and training states use the JAX package's formats
(:mod:`hcunet_tpu_torch.utils.checkpoint`), so either package resumes the
other's.  ``RecurrentTrainer`` waits for the recurrent models.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.train.losses import cross_entropy, dice
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
        from; None keeps the model's own weights."""
        if mesh is not None:
            raise NotImplementedError("multi-device training (mesh=) is not ported yet")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        if variables is not None:
            if "params" in variables:
                from hcunet_tpu_torch.utils.port_jax import (
                    unet_state_dict_from_jax_variables,
                )

                variables = unet_state_dict_from_jax_variables(variables, model.config)
            model.load_state_dict(variables)
        model.to(self.device)
        self.opt, self.schedule = _make_tx(cfg, model.parameters())
        self.metrics = Metrics()

    def train_step(self, image, mask, pwl) -> float:
        """One step on a batch (channels-last numpy arrays or tensors);
        returns the loss before the step."""
        cfg, dev = self.cfg, self.device
        image = torch.as_tensor(image, device=dev, dtype=torch.float32)
        mask = torch.as_tensor(mask, device=dev)
        pwl = None if pwl is None else torch.as_tensor(pwl, device=dev)
        self.model.train()
        out = self.model(image)
        loss = cross_entropy(out, mask, pwl, method=cfg.loss_method)
        if cfg.dice_weight:
            loss = loss + cfg.dice_weight * dice(out, mask)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        if self.schedule is not None:
            self.schedule.step()
        return float(loss.detach())

    @property
    def variables(self) -> Dict:
        """The JAX ``{"params", "batch_stats"}`` tree of the model, as numpy."""
        from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict

        return jax_variables_from_unet_state_dict(self.model.state_dict(), self.model.config)

    @property
    def opt_state(self) -> Dict:
        """The optimizer state as the JAX trainer's optax state, in
        state-dict form (numpy leaves)."""
        from hcunet_tpu_torch.utils.port_jax import optax_adam_state_from_torch

        count = None if self.schedule is None else self.schedule.last_epoch
        return optax_adam_state_from_torch(
            self.opt, self.model, self.model.config, self.cfg.weight_decay, count
        )

    def _iter_batches(self, dataset):
        """Yield the dataset's samples one by one (one device: a batch is a
        sample)."""
        for i in range(len(dataset)):
            yield dataset[i]

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
        from hcunet_tpu_torch.utils.port_jax import (
            torch_adam_state_from_optax,
            unet_state_dict_from_jax_variables,
        )

        with open(path, "rb") as f:
            state = msgpack_restore(f.read())
        want = 3 if self.cfg.weight_decay else 2
        if len(state["opt_state"]) != want:
            raise ValueError(
                f"the training state's optimizer chain has {len(state['opt_state'])} "
                f"entries; this TrainConfig's has {want}"
            )
        self.model.load_state_dict(
            unet_state_dict_from_jax_variables(state["variables"], self.model.config)
        )
        opt_sd, count = torch_adam_state_from_optax(
            state["opt_state"], self.opt, self.model, self.model.config
        )
        self.opt.load_state_dict(opt_sd)
        if (count is None) != (self.schedule is None):
            raise ValueError("the training state and this TrainConfig differ on gamma")
        if self.schedule is not None:
            self.schedule.last_epoch = count
            for group, base in zip(self.opt.param_groups, self.schedule.base_lrs):
                group["lr"] = base * self.schedule.lr_lambdas[0](count)

