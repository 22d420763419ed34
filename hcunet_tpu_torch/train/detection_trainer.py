"""Detection trainer (twin of ``hcunet_tpu/train/detection_trainer.py``,
single device): the ``hcat.train.frcnn`` contract
(``hcat/train/train_fastercnn_func.py:8-70``) for the port's
:class:`~hcunet_tpu_torch.models.detection.Detector`.

Semantics kept from the JAX trainer: an epoch loop over a Section-style
dataset, nan/inf input guards that raise, the four torchvision loss terms
summed with ``loss_classifier`` scaled, AdamW (decay on every parameter, as
``optax.adamw``) with a staircase exponential decay every
``steps_per_epoch`` steps or a linear warmup then cosine decay, per-epoch
summed-loss reporting.

A batch of B > 1 images is B single-image losses (``Detector.losses`` at
B=1, each from the same starting batch statistics, as the JAX trainer's
``vmap``): the loss and its gradient are the batch mean, and the new
running statistics the mean of the B per-sample updates.  Each sample's
backward runs before the next sample's forward, so only one image's
activations are alive at a time.

With a ``mesh``, the B images of a step split over the ``data`` devices:
image ``b`` runs on the device of replica ``b // (B / data)``, through a
copy of the detector placed there whose parameters are differentiable
copies of the trainer's (large kernels as Cout slices on the ``model``
devices, :class:`~hcunet_tpu_torch.parallel.train.ShardedParams`), so the
loss, gradient and statistics are those of the same B images on one
device.  Steps run float32 with TF32 off
(:func:`~hcunet_tpu_torch.core.precision.exact_float32`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import copy

import numpy as np
import torch
from torch import nn

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.utils.logging import Metrics, get_logger

log = get_logger(__name__)


@dataclass
class DetectionTrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    gamma: float = 0.997  # ExponentialLR per epoch
    epochs: int = 5000
    classifier_scale: float = 3.0  # train_rcnn.py:64 'scale'
    max_gt: int = 64  # static padding for ground-truth boxes
    # Alternative schedule (beyond the reference's ExponentialLR): linear
    # warmup to ``learning_rate`` then cosine decay over ``total_steps``.
    schedule: str = "exp"  # "exp" | "cosine"
    warmup_steps: int = 0
    total_steps: int = 0  # required for schedule="cosine"


def _lr_factor(cfg: DetectionTrainConfig, steps_per_epoch: int):
    """The schedule as a factor of ``learning_rate`` by step count:
    ``optax.exponential_decay(..., staircase=True)`` or
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, total)``."""
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("schedule='cosine' requires total_steps > 0")
        warmup = max(cfg.warmup_steps, 1)
        decay = cfg.total_steps - warmup
        if decay <= 0:
            raise ValueError(
                f"schedule='cosine' needs total_steps above the warmup, got "
                f"total_steps={cfg.total_steps} and warmup {warmup}"
            )

        def cosine(step: int) -> float:
            if step < warmup:
                return step / warmup
            t = min(step - warmup, decay)
            return 0.5 * (1 + math.cos(math.pi * t / decay))

        return cosine
    every = max(steps_per_epoch, 1)
    gamma = cfg.gamma
    return lambda step: gamma ** (step // every)


class DetectionTrainer:
    def __init__(
        self,
        detector,
        variables: Optional[Mapping] = None,
        cfg: DetectionTrainConfig = DetectionTrainConfig(),
        steps_per_epoch: int = 1,
        mesh=None,
        batch_size: Optional[int] = None,
        device=None,
    ):
        """``detector``: the port's ``Detector``, trained in place (moved to
        ``device``, CUDA unless given).  ``variables``: the JAX ``{"trunk",
        "head"}`` tree or the detector's state dict to start from; None keeps
        its own weights.  ``batch_size`` (default 1) samples per optimizer
        step; with batching, the per-epoch decay needs ``steps_per_epoch`` =
        ceil(len(dataset) / batch_size).

        ``mesh``: a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh`; a step's
        images then split over its ``data`` devices, ``batch_size``
        defaults to the ``data`` axis's size and must be a multiple of it,
        and ``device`` is the first ``data`` device."""
        self.det = detector
        self.cfg = cfg
        self._sharded = None
        if variables is not None:
            if "trunk" in variables:
                from hcunet_tpu_torch.utils.port_jax import (
                    detector_state_dict_from_jax_variables,
                )

                variables = detector_state_dict_from_jax_variables(
                    variables, detector.backbone_name
                )
            detector.load_state_dict(variables)
        if mesh is not None:
            self._sharded = _ShardedDetector(detector, mesh)
            device = self._sharded.home
            batch_size = batch_size or self._sharded.data_size
            if batch_size % self._sharded.data_size:
                raise ValueError(
                    f"batch_size {batch_size} must be a multiple of the mesh's data axis "
                    f"({self._sharded.data_size})"
                )
        self.device = resolve_device(device)
        detector.device = self.device
        detector.to(self.device)
        self.batch_size = batch_size or 1
        leaves = detector.parameters() if self._sharded is None else self._sharded.params.leaves()
        self.opt = torch.optim.AdamW(
            leaves, lr=cfg.learning_rate, weight_decay=cfg.weight_decay
        )
        # optax reads the step count before it increments it: the schedule
        # steps after the optimizer
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.opt, _lr_factor(cfg, steps_per_epoch)
        )
        self.metrics = Metrics()
        self.last_losses: Dict[str, float] = {}

    @property
    def variables(self) -> Dict:
        """The JAX ``{"trunk", "head"}`` variable tree, as numpy."""
        from hcunet_tpu_torch.utils.port_jax import jax_variables_from_detector_state_dict

        if self._sharded is not None:
            self._sharded.params.sync_model()
        return jax_variables_from_detector_state_dict(
            self.det.state_dict(), self.det.backbone_name
        )

    def _pad_gt(self, boxes, labels):
        if len(labels) > self.cfg.max_gt:
            raise ValueError(
                f"sample has {len(labels)} ground-truth boxes but max_gt="
                f"{self.cfg.max_gt}; raise DetectionTrainConfig.max_gt — "
                f"silently dropping boxes would train them as background"
            )
        n = len(labels)
        pb = np.zeros((self.cfg.max_gt, 4), np.float32)
        pl = np.zeros((self.cfg.max_gt,), np.int32)
        pv = np.zeros((self.cfg.max_gt,), bool)
        pb[:n] = np.asarray(boxes, np.float32)[:n]
        pl[:n] = np.asarray(labels, np.int32)[:n]
        pv[:n] = True
        return pb, pl, pv

    @staticmethod
    def _guard_finite(image: torch.Tensor) -> None:
        if bool(torch.isnan(image).any()):
            raise ValueError("image is nan")
        if bool(torch.isinf(image).any()):
            raise ValueError("image is inf")

    def _sample_loss(self, image, target, losses_fn=None):
        """One image's summed loss (classifier scaled), its terms and the
        trunk's new running statistics, by ``losses_fn`` (the detector's
        ``losses`` unless given) on ``image``'s device."""
        dev = image.device
        pb, pl, pv = (torch.from_numpy(a).to(dev) for a in self._pad_gt(
            target["boxes"], target["labels"]))
        losses, stats = (losses_fn or self.det.losses)(image, pb, pl, pv, train=True)
        total = 0.0
        for k, v in losses.items():
            total = total + (v * self.cfg.classifier_scale if k == "loss_classifier" else v)
        return total, losses, stats

    @exact_float32()
    def _step(self, images: torch.Tensor, targets) -> float:
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        self._guard_finite(images)
        B = images.shape[0]
        self.opt.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.device)
        terms: Dict[str, torch.Tensor] = {}
        stats: Dict[str, torch.Tensor] = {}
        sample_losses = (self._sharded.sample_losses(B) if self._sharded is not None
                         else [(self.device, None)] * B)
        for b, (dev, losses_fn) in enumerate(sample_losses):
            loss, losses, new = self._sample_loss(images[b : b + 1].to(dev), targets[b], losses_fn)
            (loss / B).backward()
            total = total + loss.detach().to(self.device)
            for k, v in losses.items():
                terms[k] = terms.get(k, 0.0) + v.detach().to(self.device) / B
            for k, v in new.items():
                stats[k] = stats.get(k, 0.0) + v.to(self.device) / B
        self.opt.step()
        self.schedule.step()
        sd = self.det.state_dict()
        with torch.no_grad():
            for k, v in stats.items():
                sd[k].copy_(v)
        self.last_losses = {k: float(v) for k, v in terms.items()}
        return float(total / B)

    def train_step_batch(self, images, targets) -> float:
        """One optimizer step on a batch: ``images`` ``[B, H, W, 3]``;
        ``targets`` a list of B ``{'boxes', 'labels'}`` dicts.  Returns the
        batch-mean summed loss."""
        return self._step(images, targets)

    def train_step(self, image, boxes, labels) -> float:
        """``image``: ``[1, H, W, 3]``; ``boxes``: ``[N, 4]``; ``labels``:
        ``[N]``."""
        if self._sharded is not None and self.batch_size != 1:
            raise ValueError(
                f"the mesh trainer steps on global batches of {self.batch_size}; "
                f"use train_step_batch or fit"
            )
        return self._step(image, [{"boxes": boxes, "labels": labels}])

    def _iter_batches(self, dataset):
        """Yield ``(images [B,H,W,3], [targets])`` groups of ``batch_size``
        samples (wrapping to fill the last group, so that every step has a
        full batch)."""
        n = len(dataset)
        for g0 in range(0, n, self.batch_size):
            samples = [dataset[(g0 + k) % n] for k in range(self.batch_size)]
            shapes = {np.asarray(im).shape[1:3] for im, _ in samples}
            if len(shapes) > 1:
                raise ValueError(
                    "batch_size>1 stacks images into one [B,H,W,3] array, "
                    f"but the dataset yields mixed sizes {sorted(shapes)}; "
                    "crop/resize to a common size (e.g. random_crop) or "
                    "train with batch_size=1 (per-sample dispatch handles "
                    "any size)"
                )
            images = np.concatenate(
                [
                    np.asarray(im)[..., :3] if im.shape[-1] > 3 else np.asarray(im)
                    for im, _ in samples
                ],
                axis=0,
            )
            yield images, [t for _, t in samples]

    @exact_float32()
    def fit(self, dataset, epochs: Optional[int] = None) -> List[float]:
        epochs = epochs if epochs is not None else self.cfg.epochs
        summed_losses: List[float] = []
        prev_sum = 0.0
        for e in range(epochs):
            t0 = time.perf_counter()
            total = 0.0
            if self.batch_size > 1:
                for images, targets in self._iter_batches(dataset):
                    total += self.train_step_batch(images, targets)
            else:
                for i in range(len(dataset)):
                    image, target = dataset[i]
                    total += self.train_step(
                        image[..., :3] if image.shape[-1] > 3 else image,
                        target["boxes"], target["labels"],
                    )
            summed_losses.append(total)
            self.metrics.write(epoch=e, summed_loss=total)
            log.info(
                "epoch %d | PSL %.6f | SL %.6f | TE %.2fs",
                e, prev_sum, total, time.perf_counter() - t0,
            )
            prev_sum = total
        return summed_losses


class _Losses(nn.Module):
    """``forward`` is the detector's ``losses``, so that
    ``torch.func.functional_call`` can run it on other parameters."""

    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, *args, **kwargs):
        return self.det.losses(*args, **kwargs)


class _ShardedDetector:
    """The detector over a mesh, for training: its parameters placed by
    :class:`~hcunet_tpu_torch.parallel.train.ShardedParams` and one copy of
    the module on each distinct ``data`` device (the detector itself on
    the first), whose buffers follow the detector's."""

    def __init__(self, detector, mesh):
        from hcunet_tpu_torch.parallel.mesh import (
            batch_sharding,
            canonical_device,
            require_mesh,
            shard_params,
        )
        from hcunet_tpu_torch.parallel.train import ShardedParams
        from hcunet_tpu_torch.utils.port_jax import jax_variables_from_detector_state_dict

        self.devices = [canonical_device(d) for d in batch_sharding(require_mesh(mesh)).devices]
        self.home = self.devices[0]
        self.data_size = len(self.devices)
        self.det = detector.to(self.home)
        detector.device = self.home
        names = [n for n, _ in detector.named_parameters()]
        split = shard_params(
            detector.state_dict(), names, mesh,
            lambda sd: jax_variables_from_detector_state_dict(sd, detector.backbone_name),
        )
        self.params = ShardedParams(detector, mesh, split, self.home)
        self.modules = {}
        for d in self.devices:
            if d not in self.modules:
                rep = detector if d == self.home else copy.deepcopy(detector).to(d)
                rep.device = d
                self.modules[d] = _Losses(rep)

    def sample_losses(self, B: int) -> list:
        """``(device, losses_fn)`` of each of a step's ``B`` images: the
        ``data`` replica's device and the detector's ``losses`` there on the
        trainer's parameters (copied there once per step)."""
        per = B // self.data_size
        if per * self.data_size != B:
            raise ValueError(f"{B} images do not split over {self.data_size} data devices")
        with torch.no_grad():
            for d, mod in self.modules.items():
                if d != self.home:
                    for dst, src in zip(mod.det.buffers(), self.det.buffers()):
                        dst.copy_(src)
        placed = {}
        out = []
        for b in range(B):
            d = self.devices[b // per]
            if d not in placed:
                state = {"det." + k: v for k, v in self.params.full(d).items()}
                placed[d] = _losses_on(self.modules[d], state)
            out.append((d, placed[d]))
        return out


def _losses_on(module: _Losses, state):
    """``module``'s detector's ``losses`` with the parameters ``state``."""

    def losses(*args, **kwargs):
        return torch.func.functional_call(module, state, args, kwargs)

    return losses
