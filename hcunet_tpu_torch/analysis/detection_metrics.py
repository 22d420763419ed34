"""Detection accuracy metrics: VOC-style average precision and recall
(twin of ``hcunet_tpu/analysis/detection_metrics.py``; host numpy, the same
code).

The reference has no detection metric at all — detector quality is assessed
by eyeballing box overlays (``hcat/utils.py:380-418``).  This provides the
standard measurement: per-class AP at an IoU threshold (all-point
interpolation, PASCAL VOC 2010+ style), mAP, and recall — the measure the
JAX package's ``scripts/eval_detector_map.py`` reports.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (area under the PR envelope)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_detections(
    predictions: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.5,
) -> Dict:
    """Compute per-class AP / recall over a dataset.

    ``predictions[i]``: dict with ``boxes [N,4] (x1,y1,x2,y2)``,
    ``scores [N]``, ``labels [N]`` for image i (only valid rows).
    ``ground_truths[i]``: dict with ``boxes [M,4]``, ``labels [M]``.

    Returns ``{"map": float, "per_class": {label: {"ap", "recall",
    "n_gt"}}, "recall": float}``.
    """
    assert len(predictions) == len(ground_truths)
    labels = sorted(
        {int(l) for gt in ground_truths for l in np.asarray(gt["labels"]).ravel()}
    )
    per_class = {}
    total_tp = 0
    total_gt = 0
    for cls in labels:
        records: List[Tuple[float, bool]] = []  # (score, is_tp)
        n_gt = 0
        for pred, gt in zip(predictions, ground_truths):
            gt_mask = np.asarray(gt["labels"]).ravel() == cls
            gt_boxes = np.asarray(gt["boxes"]).reshape(-1, 4)[gt_mask]
            n_gt += len(gt_boxes)
            p_mask = np.asarray(pred["labels"]).ravel() == cls
            p_boxes = np.asarray(pred["boxes"]).reshape(-1, 4)[p_mask]
            p_scores = np.asarray(pred["scores"]).ravel()[p_mask]
            order = np.argsort(-p_scores, kind="stable")
            p_boxes, p_scores = p_boxes[order], p_scores[order]
            iou = _iou_matrix(p_boxes, gt_boxes)
            taken = np.zeros(len(gt_boxes), bool)
            for i in range(len(p_boxes)):
                tp = False
                if len(gt_boxes):
                    j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                    if iou[i, j] >= iou_thresh and not taken[j]:
                        taken[j] = True
                        tp = True
                records.append((float(p_scores[i]), tp))
        if not records:
            per_class[cls] = {"ap": 0.0, "recall": 0.0, "n_gt": n_gt}
            total_gt += n_gt
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.asarray([r[1] for r in records], np.float64)
        cum_tp = np.cumsum(tps)
        cum_fp = np.cumsum(1.0 - tps)
        recall = cum_tp / max(n_gt, 1)
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
        ap = _ap_from_pr(recall, precision) if n_gt else 0.0
        per_class[cls] = {
            "ap": ap,
            "recall": float(recall[-1]) if n_gt else 0.0,
            "n_gt": n_gt,
        }
        total_tp += int(cum_tp[-1]) if n_gt else 0
        total_gt += n_gt
    aps = [v["ap"] for v in per_class.values() if v["n_gt"] > 0]
    return {
        "map": float(np.mean(aps)) if aps else 0.0,
        "per_class": per_class,
        "recall": total_tp / total_gt if total_gt else 0.0,
    }
