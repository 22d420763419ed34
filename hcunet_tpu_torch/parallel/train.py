"""Sharded training: data parallel × channel (model) parallel over a device
mesh (twin of ``hcunet_tpu/parallel/train.py``).

A step computes what the single-device step computes on the global batch:

* the batch splits over the ``data`` axis; data replica ``r`` runs the
  forward and its backward on ``mesh.axis_devices("data")[r]`` (the
  ``spatial`` and ``model`` axes replicate the batch, as the JAX
  ``batch_sharding`` does, so their other devices compute nothing but hold
  parameter slices);
* train-mode batch norm takes global-batch statistics: each replica's sums
  of ``x`` and ``x * x`` are reduced over the data replicas before flax's
  formula (:func:`~hcunet_tpu_torch.ops.conv.batch_stat_reduction`), which
  makes the replicas advance in lockstep, one thread each;
* the replicas' outputs are copied (differentiably) to the first data
  device, where the loss is computed on the whole batch, so its gradient is
  the global-batch gradient: every replica reads its parameters through
  differentiable copies (``.to()``), and autograd sums the replicas'
  contributions into the parameters.  Nothing is scaled by hand;
* parameters that the JAX rule (:func:`~.mesh.shard_params`) puts on the
  ``model`` axis live as Cout slices on the ``model``-axis devices, and so
  do their Adam moments; each step gathers them where they are used (a
  differentiable concatenation of copies), the gradient flows back to each
  slice, and the optimizer steps each slice on its own device: FSDP's
  gather-then-compute, with the JAX package's arithmetic.  Replicated
  parameters live on the first data device.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.ops.conv import batch_stat_reduction
from hcunet_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    canonical_device,
    require_mesh,
    shard_params,
)


class ShardedParams:
    """A model's parameters over a mesh: ``pieces[name]`` is ``[the
    model's own Parameter]`` (replicated, on ``home``) or the parameter's
    ``m`` slices along its split dim, one on each ``model``-axis device."""

    def __init__(self, model: nn.Module, mesh: Mesh, split: Mapping[str, Optional[int]], home):
        self.model = model
        self.split = dict(split)
        self.home = canonical_device(home)
        self.slice_devices = (mesh.axis_devices(MODEL_AXIS)
                              if MODEL_AXIS in mesh.axis_names else [self.home])
        self.pieces: Dict[str, List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if self.split[name] is None:
                self.pieces[name] = [p]
            else:
                self.pieces[name] = [
                    c.detach().to(d).clone().requires_grad_(True)
                    for c, d in zip(p.detach().chunk(len(self.slice_devices), self.split[name]),
                                    self.slice_devices)
                ]

    def leaves(self) -> List[torch.Tensor]:
        """The tensors the optimizer steps, in the model's parameter order."""
        return [t for ps in self.pieces.values() for t in ps]

    def full(self, device) -> Dict[str, torch.Tensor]:
        """Every parameter whole on ``device``, through differentiable
        copies (a replicated parameter already there is itself)."""
        out = {}
        for name, ps in self.pieces.items():
            if self.split[name] is None:
                out[name] = ps[0].to(device)
            else:
                out[name] = torch.cat([t.to(device) for t in ps], dim=self.split[name])
        return out

    @torch.no_grad()
    def sync_model(self) -> None:
        """Write the gathered slices into the model's own parameters (which
        then hold the values a save or a ``variables`` read)."""
        for name, p in self.model.named_parameters():
            if self.split[name] is not None:
                p.copy_(torch.cat([t.to(p.device) for t in self.pieces[name]], self.split[name]))

    @torch.no_grad()
    def load_model(self) -> None:
        """The inverse: the model's parameters into the slices."""
        for name, p in self.model.named_parameters():
            d = self.split[name]
            if d is not None:
                for t, c in zip(self.pieces[name], p.chunk(len(self.pieces[name]), d)):
                    t.copy_(c)

    def gathered_state(self, optimizer: torch.optim.Optimizer) -> Dict[torch.Tensor, dict]:
        """The optimizer's per-parameter state keyed by the model's own
        parameters, with the slices' moments concatenated (the form
        :func:`~hcunet_tpu_torch.utils.port_jax.optax_adam_state_from_torch`
        reads)."""
        out = {}
        for name, p in self.model.named_parameters():
            states = [optimizer.state.get(t, {}) for t in self.pieces[name]]
            if not states[0]:
                continue
            d = self.split[name]
            out[p] = states[0] if d is None else {
                k: (torch.cat([s[k].to(p.device) for s in states], d) if k != "step" else v)
                for k, v in states[0].items()
            }
        return out

    def scatter_state(self, optimizer: torch.optim.Optimizer, full: Mapping) -> None:
        """Inverse of :meth:`gathered_state`: ``full`` maps the model's own
        parameters to their whole state; each slice gets its share, on its
        device."""
        for name, p in self.model.named_parameters():
            st = full.get(p)
            if not st:
                continue
            d = self.split[name]
            for k, t in enumerate(self.pieces[name]):
                optimizer.state[t] = {
                    key: (v.clone() if key == "step" or d is None
                          else v.chunk(len(self.pieces[name]), d)[k].to(t.device).clone())
                    for key, v in st.items()
                }


class _Lockstep:
    """The data replicas' batch-statistics reduction: each replica thread
    posts its sums, waits for the others, and adds all of them up in
    replica order on its own device (differentiable copies), so every
    replica holds the same global sums."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots: List = [None] * n

    def reducer(self, rank: int) -> Callable:
        def reduce(sums: torch.Tensor, count: int):
            self.slots[rank] = (sums, count)
            self.barrier.wait()
            total = self.slots[0][0].to(sums.device)
            for other, _c in self.slots[1:]:
                total = total + other.to(sums.device)
            n_total = sum(c for _s, c in self.slots)
            self.barrier.wait()  # every replica has read the slots
            return total, n_total

        return reduce

    def run(self, fns: Sequence[Callable]) -> list:
        """Run ``fns[r]`` in thread ``r``; return their results, or raise
        the first failure (after releasing the others' waits)."""
        results: list = [None] * self.n
        errors: list = []

        def work(r):
            try:
                results[r] = fns[r]()
            except BaseException as e:  # noqa: BLE001 - re-raised in the caller
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=work, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


class DataModelParallel:
    """The forward of ``model`` over a mesh, for training: the ``data``
    replicas of the module and the parameters' placement
    (:class:`ShardedParams`).  ``to_jax`` is the model's state-dict -> JAX
    tree converter, through which the ``model`` axis's rule reads each
    parameter's JAX shape."""

    def __init__(self, model: nn.Module, mesh: Mesh, to_jax: Callable, min_size: int = 32):
        self.mesh = require_mesh(mesh)
        self.placement = batch_sharding(mesh)
        self.devices = [canonical_device(d) for d in self.placement.devices]
        self.home = self.devices[0]
        self.model = model.to(self.home)
        names = [n for n, _ in model.named_parameters()]
        split = shard_params(model.state_dict(), names, mesh, to_jax, min_size)
        self.params = ShardedParams(model, mesh, split, self.home)
        # one module per replica: the threads swap parameters into their own
        self.replicas = [model] + [copy.deepcopy(model).to(d) for d in self.devices[1:]]

    @property
    def data_size(self) -> int:
        return len(self.devices)

    def forward(self, image) -> torch.Tensor:
        """The model's output on the global batch ``image``, on ``home``:
        each replica's share of the batch through its module, with global
        batch-norm statistics, and the outputs concatenated (all
        differentiable).  The running statistics end in the model's
        buffers, as a single-device step leaves them."""
        pieces = self.placement.split(torch.as_tensor(image, dtype=torch.float32))
        n = len(pieces)
        lockstep = _Lockstep(n) if n > 1 else None
        buffers = dict(self.model.named_buffers())
        training = self.model.training

        def replica(r: int) -> Callable:
            def fwd():
                dev = self.devices[r]
                state = self.params.full(dev)
                # replica 0's buffers are the model's, updated in place; the
                # others compute the same update into copies
                state.update(buffers if r == 0 else
                             {k: b.to(dev).clone() for k, b in buffers.items()})
                module = self.replicas[r].train(training)
                ctx = (batch_stat_reduction(lockstep.reducer(r)) if lockstep
                       else contextlib.nullcontext())
                with ctx:
                    return torch.func.functional_call(module, state, (pieces[r],))

            return fwd

        fns = [replica(r) for r in range(n)]
        outs = lockstep.run(fns) if lockstep else [fns[0]()]
        return torch.cat([o.to(self.home) for o in outs], dim=0)


class TrainState(NamedTuple):
    params: ShardedParams
    batch_stats: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LRScheduler]
    step: int


class ModelLoss(NamedTuple):
    """A model and the loss of its output: ``loss_fn(out, *targets)``."""
    model: nn.Module
    loss_fn: Callable


def make_unet_loss_fn(model: nn.Module, loss_fn: Callable) -> ModelLoss:
    """Bind a U-Net and ``loss_fn(out, mask, pwl)``; a batch is ``(image,
    mask, pwl)`` channels-last."""
    return ModelLoss(model, loss_fn)


def make_sharded_train_step(
    loss: ModelLoss,
    make_optimizer: Callable,
    mesh: Mesh,
    to_jax: Callable,
    min_size: int = 32,
):
    """Build ``(init_fn, step_fn)`` over ``mesh``.

    ``make_optimizer(leaves) -> (optimizer, schedule or None)`` builds the
    optimizer over the tensors it steps (the replicated parameters and the
    ``model``-axis slices).  ``init_fn(state_dict=None)`` loads a state dict
    into the model (optional) and places it; ``step_fn(state, batch) ->
    (state, loss)`` takes the global batch ``(image, *targets)`` and steps
    once, float32 with TF32 off."""
    engine = DataModelParallel(loss.model, mesh, to_jax, min_size)

    def init_fn(state_dict: Optional[Mapping] = None) -> TrainState:
        if state_dict is not None:
            loss.model.load_state_dict(state_dict)
            engine.params.load_model()
        opt, schedule = make_optimizer(engine.params.leaves())
        return TrainState(engine.params, dict(loss.model.named_buffers()), opt, schedule, 0)

    def step_fn(state: TrainState, batch):
        image, *targets = batch
        with exact_float32():
            loss.model.train()
            value = loss.loss_fn(engine.forward(image),
                                 *(torch.as_tensor(t, device=engine.home) for t in targets))
            state.opt_state.zero_grad(set_to_none=True)
            value.backward()
            state.opt_state.step()
            if state.schedule is not None:
                state.schedule.step()
        return state._replace(step=state.step + 1), float(value.detach())

    return init_fn, step_fn
