"""On-device seeded watershed — bounded-iteration relaxation (twin of
``hcunet_tpu/ops/watershed_jax.py``).

The exact priority-flood watershed is sequential and runs on the host
(``native/watershed.cpp``).  This is the device variant: seeded label
assignment by *minimax-path* relaxation —

    cost(p)  = min over paths from a seed of   max(image along the path)
    label(p) = label of the seed achieving that cost

computed by Bellman–Ford-style iteration over the 6-neighborhood: each step
every voxel adopts the (cost, label) of its best neighbor, where moving into
voxel p costs ``max(neighbor_cost, image[p]) + compactness``.  ``iters``
bounds the path length.  A final pass zeroes voxels whose neighborhood holds
another label when ``watershed_line`` is set.

Plain PyTorch, as the JAX version is plain jnp.  The JAX ``_shift`` pads a
copy for every neighbor; here each neighbor is a pair of slicing views
(a voxel and its neighbor), and the update writes into the step's output
in place.  A voxel on the volume's edge has no neighbor beyond it, where the
JAX fill (cost 1e9, label 0) never wins, so the labels are the JAX
package's, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e9


def _shift(x: torch.Tensor, axis: int, direction: int, fill) -> torch.Tensor:
    """Neighbor copy along one axis (``out[i] = x[i - direction]``, edges
    filled), as the JAX ``_shift``."""
    out = torch.full_like(x, fill)
    n = x.shape[axis]
    if direction > 0:
        out.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
    return out


def _pairs(axis: int, direction: int, n: int):
    """(voxels, their neighbors) as ``narrow`` arguments along ``axis``:
    direction +1 reads the neighbor at i - 1, -1 the one at i + 1."""
    if direction > 0:
        return (axis, 1, n - 1), (axis, 0, n - 1)
    return (axis, 0, n - 1), (axis, 1, n - 1)


@torch.no_grad()
def watershed_device(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    iters: int = 64,
    compactness: float = 0.0,
    watershed_line: bool = False,
) -> torch.Tensor:
    """``image``: [X, Y, Z] heights (flooded ascending); ``markers``: int
    labels; ``mask``: optional bool.  Returns int32 labels on ``image``'s
    device."""
    image = image.to(torch.float32)
    markers = markers.to(torch.int32)
    valid = torch.ones_like(image, dtype=torch.bool) if mask is None else mask != 0

    seeded = (markers != 0) & valid
    cost = torch.where(seeded, image, _BIG)
    label = torch.where(seeded, markers, 0)

    axes = [a for a in range(image.ndim) if image.shape[a] > 1]
    steps = [_pairs(ax, d, image.shape[ax]) for ax in axes for d in (1, -1)]
    for _ in range(int(iters)):
        best_cost, best_label = cost.clone(), label.clone()
        for here, there in steps:
            nc, nl = cost.narrow(*there), label.narrow(*there)
            bc, bl = best_cost.narrow(*here), best_label.narrow(*here)
            cand = torch.maximum(nc, image.narrow(*here)) + compactness
            better = (cand < bc) & (nl != 0) & valid.narrow(*here)
            bc.copy_(torch.where(better, cand, bc))
            bl.copy_(torch.where(better, nl, bl))
        cost, label = best_cost, best_label
    label = torch.where(valid, label, 0)

    if watershed_line:
        boundary = torch.zeros_like(valid)
        for here, there in steps:
            nl, lb = label.narrow(*there), label.narrow(*here)
            boundary.narrow(*here).logical_or_((nl != 0) & (lb != 0) & (nl != lb))
        label = torch.where(boundary, 0, label)
    return label
