"""``hcat.loss``: the training losses with the reference's signatures and
channels-first layout (``[B, C, *spatial]``), over the port's
:mod:`hcunet_tpu_torch.train.losses`.

Each takes numpy arrays or tensors and returns a Python float.  The loss
is computed on ``pred``'s device when ``pred`` is a tensor, else on
``device`` (CUDA unless the caller names another); the targets follow it.
Targets larger than the valid-conv prediction are cropped to it, as in the
reference (``loss.py:50-56``).
"""

import torch

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.train import losses as _losses


def _channels_last(x, device) -> torch.Tensor:
    """``[B, C, *spatial]`` to a float32 channels-last tensor on
    ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float32).movedim(1, -1)


def _operands(pred, others, device):
    dev = pred.device if isinstance(pred, torch.Tensor) else resolve_device(device)
    return [None if x is None else _channels_last(x, dev) for x in (pred, *others)]


def cross_entropy(pred, mask, pwl=None, method: str = "pixel",
                  num_random_pixels=None, *, device=None) -> float:
    """``loss.py:5-101``: the PWL-weighted BCE over logits, methods
    ``pixel``, ``worst_z``, ``random`` and ``sigmoid`` (the reference's
    double sigmoid kept).

    ``method="random"`` draws from a ``torch.Generator`` seeded 0 on the
    prediction's device, where the JAX alias draws from ``PRNGKey(0)``: the
    two sample different pixels, and a CUDA generator others than a CPU
    one."""
    p, m, w = _operands(pred, (mask, pwl), device)
    kw = {}
    if num_random_pixels is not None:
        kw["num_random_pixels"] = int(num_random_pixels)
    if method == "random":
        kw["generator"] = torch.Generator(device=p.device).manual_seed(0)
    return float(_losses.cross_entropy(p, m, w, method=method, **kw))


def dice(pred, mask, *, device=None) -> float:
    """``loss.py:104-128``."""
    return float(_losses.dice(*_operands(pred, (mask,), device)))


def L1Loss(pred, mask, *, device=None) -> float:
    """``loss.py:130-153``."""
    return float(_losses.l1_loss(*_operands(pred, (mask,), device)))


def MSELoss(pred, mask, *, device=None) -> float:
    """``loss.py:155-177``."""
    return float(_losses.mse_loss(*_operands(pred, (mask,), device)))


__all__ = ["cross_entropy", "dice", "L1Loss", "MSELoss"]
