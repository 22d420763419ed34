"""Cell-candidate bookkeeping: tile-offset merge + NMS dedup (twin of
``hcunet_tpu/infer/candidates.py``).

Rebuild of ``hcat/utils.py:336-366`` (``merge_cell_candidates``): offset new
boxes by the tile origin, concatenate candidate dicts, NMS at IoU 0.20, all
in host numpy.  Boxes are ``(x1, y1, x2, y2)`` in array axes (dim0, dim1).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from hcunet_tpu_torch.ops.nms import nms_indices

MERGE_IOU = 0.20


def empty_candidates() -> Dict[str, np.ndarray]:
    return {
        "boxes": np.zeros((0, 4), np.float32),
        "scores": np.zeros((0,), np.float32),
        "labels": np.zeros((0,), np.int32),
        "z_level": np.zeros((0,), np.float32),
    }


def merge_cell_candidates(
    candidate_list: Optional[Dict[str, np.ndarray]],
    candidate_new: Dict[str, np.ndarray],
    initial_coords=(0, 0),
    iou_max: float = MERGE_IOU,
) -> Dict[str, np.ndarray]:
    new = dict(candidate_new)
    boxes = np.asarray(new["boxes"], np.float32).copy().reshape(-1, 4)
    boxes[:, [0, 2]] += initial_coords[0]
    boxes[:, [1, 3]] += initial_coords[1]
    new["boxes"] = boxes

    if candidate_list is None or len(candidate_list.get("scores", [])) == 0:
        merged = {k: np.asarray(v) for k, v in new.items()}
    else:
        merged = {
            k: np.concatenate([np.asarray(candidate_list[k]), np.asarray(new[k])])
            for k in ("boxes", "scores", "labels", "z_level")
        }
    if len(merged["scores"]) == 0:
        return empty_candidates()
    keep = nms_indices(merged["boxes"], merged["scores"], iou_max)
    return {k: merged[k][keep] for k in merged}
