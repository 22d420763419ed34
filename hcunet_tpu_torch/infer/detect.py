"""Tiled 2D detection over a z-stack — hot loop #2 (twin of
``hcunet_tpu/infer/detect.py``; ``hcat/segment.py:139-218``).

All z planes of one tile position form one batch, so there is one
``Detector.detect`` call per tile position; per-tile results merge into the
global candidate list with NMS (``utils.merge_cell_candidates``).  The tile
grid (``DET_EVAL``, ``DET_PAD``, ``calculate_indexes``) is the JAX
package's.

Box convention: the detector emits torchvision-style ``(x1, y1, x2, y2)``
with x the width axis (array dim 1 of an ``[H, W]`` tile); candidates store
boxes in the volume's array axes (dim0, dim1), so the axes are swapped at the
boundary: detector ``(x, y)`` → array ``(det_y + tile_x0, det_x + tile_y0)``.

:func:`dispatch_cell_candidates` enqueues each tile's work on the current
CUDA stream and returns without copying results back; the detector's NMS
steps read one convergence flag each from the card.
:func:`collect_cell_candidates` copies the results to the host (where it
waits for the card) and merges them.  :class:`ShardedDetect` splits the
z-plane batch over every device of a mesh.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.core.shapes import calculate_indexes
from hcunet_tpu_torch.infer.candidates import empty_candidates, merge_cell_candidates

DET_PAD = (24, 24)
# the JAX package's tile core; calculate_indexes cuts 1000 + 2*24 - 1 =
# 1047-wide windows
DET_EVAL = (1000, 1000)


@exact_float32()
def dispatch_cell_candidates(
    image,
    detector,
    eval_size=DET_EVAL,
    pad=DET_PAD,
    device=None,
):
    """Enqueue the per-tile detection work.

    ``image``: ``[X, Y, Z, C>=3]`` (channels-last, normalized), host numpy or
    a tensor already on the card — then the detector's channels are sliced
    there and detection costs no second host→device copy.  ``device`` (CUDA
    unless given) must be the detector's.  Returns an opaque list of
    in-flight tiles for :func:`collect_cell_candidates`."""
    dev = resolve_device(device)
    if dev != detector.device:
        raise ValueError(f"detector is on {detector.device}, asked to run on {dev}")
    X, Y, Z = image.shape[:3]
    eval_size = [min(e, s) for e, s in zip(eval_size, (X, Y))]

    # whole-axis window whenever a tiled grid can't fit (axis < eval+2*pad)
    if X < eval_size[0] + 2 * pad[0]:
        x_ind = [[0, X]]
    else:
        x_ind = calculate_indexes(pad[0], eval_size[0], X, X)
    if Y < eval_size[1] + 2 * pad[1]:
        y_ind = [[0, Y]]
    else:
        y_ind = calculate_indexes(pad[1], eval_size[1], Y, Y)

    pending = []
    for x0, x1 in x_ind:
        for y0, y1 in y_ind:
            tile = image[x0:x1, y0:y1, :, :3]  # [H, W, Z, 3]
            if isinstance(tile, np.ndarray):
                batch = torch.from_numpy(
                    np.ascontiguousarray(np.moveaxis(tile, 2, 0), np.float32)
                )
            else:
                batch = tile.movedim(2, 0).float()
            out = detector.detect(batch)  # [Z, H, W, 3] planes as the batch
            pending.append((x0, x1, y0, y1, Z, out))
    return pending


def collect_cell_candidates(
    pending,
    initial_coords=(0, 0),
    score_floor: float = 0.0,
    progress=None,
) -> Dict[str, np.ndarray]:
    """Copy the dispatched detections to the host and NMS-merge them into
    the global candidate list (``utils.merge_cell_candidates`` semantics)."""
    candidates = None
    for x0, x1, y0, y1, Z, out in pending:
        boxes = out["boxes"].cpu().numpy()  # [Z, K, 4] detector axes
        scores = out["scores"].cpu().numpy()
        labels = out["labels"].cpu().numpy()
        valid = out["valid"].cpu().numpy() & (scores > score_floor)

        for z in range(Z):
            v = valid[z]
            if not v.any():
                continue
            det = boxes[z][v]
            # detector (x=W=dim1, y=H=dim0) -> array axes (dim0, dim1)
            arr_boxes = np.stack([det[:, 1], det[:, 0], det[:, 3], det[:, 2]], axis=1)
            new = {
                "boxes": arr_boxes.astype(np.float32),
                "scores": scores[z][v].astype(np.float32),
                "labels": labels[z][v].astype(np.int32),
                "z_level": np.full(v.sum(), float(z), np.float32),
            }
            candidates = merge_cell_candidates(
                candidates, new,
                initial_coords=(x0 + initial_coords[0], y0 + initial_coords[1]),
            )
        if progress:
            progress(f"detect tile [{x0}:{x1}, {y0}:{y1}]")
    return candidates if candidates is not None else empty_candidates()


class ShardedDetect:
    """Data-parallel detection over a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh`
    (twin of the JAX ``ShardedDetect``).

    Each z plane's proposals, RoI heads and NMS are its own, so the batch of
    planes splits over EVERY mesh device with the per-plane computation
    untouched: the batch is zero-padded to a multiple of ``mesh.size`` (the
    padded rows lie beyond the ``Z`` that :func:`collect_cell_candidates`
    reads), piece ``k`` runs on device ``k`` through a copy of the detector
    placed there, and the pieces' results are concatenated on ``device``
    (the detector's own unless given).  Duck-types the detector's ``detect``
    and ``device`` for :func:`dispatch_cell_candidates`.

    The copies are placed at construction and placed again only when a
    caller passes a *different* weight tree to :meth:`detect` (an identity
    check: the steady state pays no placement)."""

    def __init__(self, detector, mesh, device=None):
        import copy

        from hcunet_tpu_torch.parallel.mesh import canonical_device, tiles_sharding

        self.detector = detector
        self.device = resolve_device(detector.device if device is None else device)
        self.placement = tiles_sharding(mesh)
        home = canonical_device(detector.device)
        self._replicas = {}
        for d in self.placement.devices:
            if d not in self._replicas:
                if d == home:
                    self._replicas[d] = detector
                else:
                    rep = copy.deepcopy(detector).to(d)
                    rep.device = d
                    self._replicas[d] = rep
        self._src = None  # the weight tree placed last, by identity

    @exact_float32()
    def detect(self, images, variables=None) -> Dict[str, torch.Tensor]:
        """``images`` ``[B, H, W, 3]``; ``variables`` (optional): a weight
        tree (the detector's state dict, or the JAX ``{"trunk", "head"}``
        tree) to detect with, loaded into every copy when it is not the one
        placed last."""
        if variables is not None and variables is not self._src:
            sd = variables
            if "trunk" in variables:
                from hcunet_tpu_torch.utils.port_jax import (
                    detector_state_dict_from_jax_variables,
                )

                sd = detector_state_dict_from_jax_variables(
                    variables, self.detector.backbone_name
                )
            for rep in self._replicas.values():
                rep.load_state_dict(sd)
            self._src = variables
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        n = len(self.placement.devices)
        Z = images.shape[0]
        Zp = -(-Z // n) * n
        if Zp != Z:
            images = torch.cat([images, images.new_zeros((Zp - Z, *images.shape[1:]))])
        outs = [self._replicas[piece.device].detect(piece)
                for piece in self.placement.split(images)]
        return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}


@exact_float32()
def predict_cell_candidates(
    image,
    detector,
    eval_size=DET_EVAL,
    pad=DET_PAD,
    initial_coords=(0, 0),
    score_floor: float = 0.0,
    progress=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """``image``: ``[X, Y, Z, C>=3]`` volume (channels-last, already
    normalized; the pipeline passes channels (0, 2, 3) like
    ``hcat/main.py:99``); ``detector``: a
    :class:`~hcunet_tpu_torch.models.detection.Detector` on ``device``
    (CUDA unless given).  Returns the merged candidate dict with boxes in
    array axes (x=dim0, y=dim1), plus per-box ``z_level``."""
    return collect_cell_candidates(
        dispatch_cell_candidates(image, detector, eval_size, pad, device),
        initial_coords=initial_coords,
        score_floor=score_floor,
        progress=progress,
    )
