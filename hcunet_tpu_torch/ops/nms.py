"""Non-maximum suppression (twin of ``hcunet_tpu/ops/nms.py``).

:func:`nms_mask` is the detector's NMS on the card: a boolean keep mask over
a (padded) box array, batched over any leading dimensions, with the keep set
of the JAX package's ``fori_loop`` greedy NMS.  Instead of one step per box
it iterates the greedy rule as a fixed point over all boxes at once::

    keep <- finite & not any_j (S[j, i] & keep[j]),
    S[j, i] = iou(j, i) > threshold and j < i          (in score order)

Box i depends only on boxes before it, so after t steps the first t boxes are
final and the fixed point is unique: it is the greedy keep set.  The loop
stops at the first step that changes nothing, which is the length of the
longest suppression chain plus one, not the number of boxes.  Each step reads
one flag back from the card; :data:`NMS_STEPS` counts the steps (its
``launches``), and each call is a ``hcunet.detect.nms`` span in a profiler's
trace.

:func:`nms_indices_np` / :func:`nms_indices` are the host numpy NMS that
merges tiled candidates, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from hcunet_tpu_torch.csrc import LaunchCount
from hcunet_tpu_torch.utils.profiling import span


# raised by one at each step of nms_mask's fixed point, that is at each flag
# it reads back from the card (the detector's replicas run NMS from threads
# of their own)
NMS_STEPS = LaunchCount(("fixed_point",))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix ``[..., N, M]`` between ``[..., N, 4]`` and ``[..., M, 4]``
    boxes ``(x1, y1, x2, y2)``."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


@torch.no_grad()
def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.5,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy NMS keep mask ``[..., N]`` for boxes ``[..., N, 4]`` and
    scores ``[..., N]``, batched over the leading dimensions.

    Boxes are visited in stable descending-score order; a box whose score is
    ``-inf`` (or whose ``valid`` is False) is never kept and suppresses
    nothing.  Each step of the fixed point costs one pass over the ``N x N``
    overlap matrix; the loop reads one flag back from the card per step."""
    with span("hcunet.detect.nms"):
        if valid is not None:
            scores = torch.where(valid, scores, -torch.inf)
        n = scores.shape[-1]
        if n == 0:
            return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
        order = torch.argsort(-scores, dim=-1, stable=True)
        b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
        s = torch.gather(scores, -1, order)
        earlier = torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1)
        overlaps = (box_iou(b, b) > iou_threshold) & earlier  # [..., j, i]
        finite = torch.isfinite(s)
        keep = finite
        while True:
            suppressed = (overlaps & keep[..., :, None]).any(dim=-2)
            new = finite & ~suppressed
            NMS_STEPS.add("fixed_point")
            if torch.equal(new, keep):
                break
            keep = new
        # back to input order
        return torch.zeros_like(keep).scatter_(-1, order, keep)


def nms_indices_np(boxes, scores, iou_threshold=0.5):
    """Greedy NMS on host numpy — same keep set as :func:`nms_mask`.
    Returns the kept indices in descending-score order."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32)
    n = len(scores)
    if n == 0:
        return np.zeros(0, np.int64)
    x1, y1, x2, y2 = boxes.T
    areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas[i] + areas - inter
        iou = np.where(union > 0, inter / union, 0.0)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def nms_indices(boxes, scores, iou_threshold=0.5, valid=None):
    """torchvision-style: indices of kept boxes in descending-score order
    (host numpy)."""
    boxes = np.asarray(boxes)
    scores = np.asarray(scores, np.float32)
    if valid is not None:
        scores = np.where(np.asarray(valid), scores, -np.inf)
    keep = nms_indices_np(boxes, scores, iou_threshold)
    return keep[np.isfinite(scores[keep])]
