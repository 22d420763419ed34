"""Segmentation losses with crop-to-valid semantics (twin of
``hcunet_tpu/train/losses.py``).

Every loss first top-left-crops the target (and weight map) to the
prediction's valid-conv output shape, then reduces, in float32.  Layout is
channels-last ``[B, *spatial, C]``; targets may be tensors or numpy arrays
and are moved to the prediction's device.

* ``pwl`` weighting multiplies the per-pixel BCE by ``pwl + 1``; the
  reference's foreground boost is dead code there, so it runs only when
  ``foreground_boost`` is set.
* ``worst_z`` sorts the per-z-plane losses and scales them by
  ``linspace(1, 2)**2``.
* ``random`` draws ``num_random_pixels`` positive and negative samples with
  replacement from an explicit ``torch.Generator`` (``torch.multinomial``
  where the JAX package draws ``jax.random.categorical`` from a key: the
  two give other samples from the same seed).
* ``sigmoid`` applies a sigmoid to the prediction before the
  BCE-with-logits, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

METHODS = ("pixel", "worst_z", "random", "sigmoid")


def _crop_like(target, pred: torch.Tensor) -> torch.Tensor:
    """Top-left crop ``target``'s spatial axes to ``pred``'s (channels-last),
    as a float32 tensor on ``pred``'s device."""
    target = torch.as_tensor(target, device=pred.device)
    slices = (slice(None),) + tuple(slice(0, s) for s in pred.shape[1:-1]) + (
        slice(None),
    )
    return target[slices].float()


def _bce_with_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits, in the stable form
    ``max(x, 0) - x t + log(1 + exp(-|x|))``."""
    return torch.clamp(pred, min=0.0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def cross_entropy(
    pred: torch.Tensor,
    mask,
    pwl=None,
    method: str = "pixel",
    num_random_pixels: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    foreground_boost: float = 0.0,
) -> torch.Tensor:
    """Pixel-weighted binary cross entropy (U-Net paper style).

    ``pred``: logits ``[B, *spatial, C]``; ``mask``/``pwl`` may be spatially
    larger and are cropped to ``pred``.  ``method="random"`` needs
    ``num_random_pixels > 1`` and a ``generator`` on ``pred``'s device."""
    if method not in METHODS:
        raise ValueError(
            f"viable methods for cross entropy loss are {METHODS}, not {method}"
        )
    if method == "random":
        if num_random_pixels is None or num_random_pixels <= 1:
            raise ValueError("num_random_pixels must be an int > 1")
        if generator is None:
            raise ValueError("method='random' requires a torch.Generator")

    x = pred.float()
    if method == "sigmoid":
        x = torch.sigmoid(x)
    mask = _crop_like(mask, pred)
    pwl = torch.ones_like(mask) if pwl is None else _crop_like(pwl, pred)
    if foreground_boost:
        pwl = pwl + foreground_boost * (mask > 0.5)

    if method in ("pixel", "sigmoid"):
        return torch.mean(_bce_with_logits(x, mask) * (pwl + 1.0))

    if method == "worst_z":
        loss = _bce_with_logits(x, mask) * (pwl + 1.0)
        # per-z totals (z is the last spatial axis), sorted ascending and
        # weighted quadratically toward the worst plane
        reduce_axes = tuple(i for i in range(loss.ndim) if i != loss.ndim - 2)
        per_z = torch.sort(torch.sum(loss, dim=reduce_axes)).values
        scale = torch.linspace(1.0, 2.0, per_z.shape[0], device=per_z.device) ** 2
        per_z = per_z * scale / (pred.shape[1] * pred.shape[2])
        return torch.mean(per_z)

    # method == "random": positives and negatives drawn with replacement;
    # with no positive pixel the loss is the mean over all pixels
    flat_pred = x.reshape(-1)
    flat_mask = mask.reshape(-1)
    pos_p = (flat_mask == 1).float()
    if not bool(pos_p.sum() > 0):
        return torch.mean(_bce_with_logits(flat_pred, flat_mask))
    neg_p = (flat_mask == 0).float()
    n = num_random_pixels
    # + 1e-30 as the JAX twin's log(p + 1e-30): an empty class is uniform
    idx = torch.cat([
        torch.multinomial(p + 1e-30, n, replacement=True, generator=generator)
        for p in (pos_p, neg_p)
    ])
    return torch.mean(_bce_with_logits(flat_pred[idx], flat_mask[idx]))


def dice(pred: torch.Tensor, mask, eps: float = 1e-10) -> torch.Tensor:
    """Soft dice loss on logits (``hcat/loss.py:104-128``)."""
    mask = _crop_like(mask, pred)
    p = torch.sigmoid(pred.float())
    num = 2.0 * torch.sum(p * mask) + eps
    den = torch.sum(p + mask) + eps
    return 1.0 - num / den


def l1_loss(pred: torch.Tensor, target) -> torch.Tensor:
    """Crop-to-valid mean absolute error (``hcat/loss.py:130-153``)."""
    return torch.mean(torch.abs(pred.float() - _crop_like(target, pred)))


def mse_loss(pred: torch.Tensor, target) -> torch.Tensor:
    """Crop-to-valid mean squared error (``hcat/loss.py:155-177``)."""
    return torch.mean((pred.float() - _crop_like(target, pred)) ** 2)
