"""``hcat.r_unet``: the recurrent model family, as the reference's test
drivers import it (``from hcat.r_unet import RecursiveUnet as RUnet,
RDCNet``, ``from hcat.r_unet import StackedDilation``).

:class:`RecursiveUnet` and :class:`RDCNet` are inference facades over the
port's eval-mode :class:`~hcunet_tpu_torch.models.runet.RecursiveUNet` and
:class:`~hcunet_tpu_torch.models.rdcnet.RDCNet`: the reference's
constructor keywords, ``[B, C, X, Y, Z]`` in and numpy ``[B, out, X, Y,
Z]`` out, 10 timesteps, float32.  The model lives on ``device`` (CUDA
unless the caller names another) and ``.to()``/``.cuda()``/``.cpu()`` move
it; on the card every same-padding conv of a forward is kernel K1
(``ops/conv.py::conv_same``).  The weights are the JAX initializers'
distributions (truncated He-normal kernels, zero biases) drawn from
``seed`` by an explicit generator, or the JAX package's variables, set
through :attr:`variables` (``utils/port_jax.py``).  To train, use
:class:`~hcunet_tpu_torch.train.trainer.RecurrentTrainer`.

``StackedDilation`` is the port's block (parallel 5^3 convs at dilations
1-5, ``r_unet.py:339-364``).
"""

from typing import Dict

import numpy as np
import torch

from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig, resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.models.rdcnet import RDCNet as _RDCNet
from hcunet_tpu_torch.models.rdcnet import StackedDilation  # noqa: F401
from hcunet_tpu_torch.models.runet import RecursiveUNet as _RecursiveUNet
from hcunet_tpu_torch.models.unet import init_like_flax
from hcunet_tpu_torch.utils import port_jax


class _RecurrentFacade:
    """The torch-module surface the two facades share; each family sets
    ``_to_jax``/``_from_jax`` to its converters (``utils/port_jax.py``)."""

    def _finish_init(self, model: torch.nn.Module, seed: int, device) -> None:
        init_like_flax(model, torch.Generator().manual_seed(seed), scale=2.0)
        self.model = model
        self.device = resolve_device(device)
        self.model.to(self.device).eval()

    @property
    def variables(self) -> Dict:
        """The weights as the JAX package's variable tree (numpy leaves);
        assigning such a tree loads it into the model."""
        return self._to_jax(self.model.state_dict())

    @variables.setter
    def variables(self, variables: Dict) -> None:
        self.model.load_state_dict(self._from_jax(variables))

    @exact_float32()
    def forward(self, x) -> np.ndarray:
        """``x``: ``[B, C, X, Y, Z]`` (numpy or a tensor) → numpy
        ``[B, out_channels, X, Y, Z]`` (prob, center and the z/y/x vector
        channels, ``r_unet.py:104,127``), computed on the model's device."""
        t = torch.as_tensor(x).to(device=self.device, dtype=torch.float32).movedim(1, -1)
        with torch.no_grad():
            out = self.model(t.contiguous())
        return out.float().movedim(-1, 1).cpu().numpy()

    __call__ = forward

    def eval(self):
        return self

    def train(self, mode: bool = True):
        if mode:
            raise ValueError(
                "the r_unet facade serves inference; train the model with "
                "hcunet_tpu_torch.train.trainer.RecurrentTrainer"
            )
        return self

    def to(self, device=None):
        if device is not None:
            self.device = resolve_device(device)
            self.model.to(self.device)
        return self

    def cuda(self, device=None):
        return self.to("cuda" if device is None else device)

    def cpu(self):
        return self.to("cpu")


class RecursiveUnet(_RecurrentFacade):
    """``hcat.r_unet.RecursiveUnet`` (``r_unet.py:38-160``): a GRU-style
    recurrence over a 2-level same-padding U-Net, 10 timesteps.  The
    reference's constructor keywords are taken; as in the reference, the
    channels [16, 32, 64] are fixed (``r_unet.py:102``)."""

    _to_jax = staticmethod(port_jax.jax_variables_from_runet_state_dict)
    _from_jax = staticmethod(port_jax.runet_state_dict_from_jax_variables)

    def __init__(self, image_dimensions: int = 2, in_channels: int = 4,
                 out_channels: int = 5,
                 kernel=None, upsample_kernel=(6, 6, 5),
                 max_pool_kernel=(2, 2, 1), upsample_stride=(2, 2, 1),
                 dilation: int = 1, groups: int = 1, *, seed: int = 0, device=None):
        if isinstance(kernel, dict):
            kernel = kernel["conv1"]
        cfg = RUNetConfig(
            in_channels=in_channels,
            out_channels=out_channels,
            kernel=tuple(kernel) if kernel is not None else (3, 3, 3),
            upsample_kernel=tuple(upsample_kernel),
            max_pool_kernel=tuple(max_pool_kernel),
            upsample_stride=tuple(upsample_stride),
        )
        self.config = cfg
        self._finish_init(_RecursiveUNet(cfg), seed, device)


class RDCNet(_RecurrentFacade):
    """``hcat.r_unet.RDCNet`` (``r_unet.py:207-227``): a stride-2 input
    conv, 10 iterations of ``y += RDCBlock(cat(x, y))`` over stacked
    dilations, and a transposed conv back to full resolution."""

    _to_jax = staticmethod(port_jax.jax_variables_from_rdcnet_state_dict)
    _from_jax = staticmethod(port_jax.rdcnet_state_dict_from_jax_variables)

    def __init__(self, in_channels: int = 4, out_channels: int = 5, *,
                 seed: int = 0, device=None):
        cfg = RDCNetConfig(in_channels=in_channels, out_channels=out_channels)
        self.config = cfg
        self._finish_init(_RDCNet(cfg), seed, device)


__all__ = ["RecursiveUnet", "RDCNet", "StackedDilation"]
