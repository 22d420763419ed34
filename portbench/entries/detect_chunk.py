"""Entry ``detect_chunk``: ``analyze``'s detection stage on a chunk that is
already on the card, through the serial API ``hcat`` callers use.

The program: the configuration's Faster R-CNN ResNet50-FPN
(``models/detection.py::Detector``) with the benchmark's weights, float32,
driven by ``infer/detect.py::predict_cell_candidates``: the detector's
channels sliced on the card from the normalized ``[X, Y, Z, 4]`` volume, as
``analyze`` slices them, windows of the configuration's tile grid with all
z-planes of a window as one batch, then the read-back (pageable ``.cpu()``
copies) and the host merge, one after the other on the calling thread.
``analyze`` itself runs the same dispatch but reads back through pinned
copies and merges on a tail worker while the card runs the U-Net
(``infer/pipeline.py::_dispatch_chunk`` and ``_finish_chunk``), so there the
card does not wait for the merge as it does here.  A request returns the
merged candidates (host numpy).  The pool's volumes are made on the card
before the window; one request of each distinct depth warms the program
up.  The weights are made once a run (:func:`weights`); the seconds their
calibration takes are inside ``setup_s`` and reported apart, not compared,
as ``calibration_s``.

Random weights make top-k and NMS flip on rounding, so the check compares
the continuous outputs with the reference's and holds each discrete stage
to the reference's on the program's own inputs to that stage.  On the
sampled request, on one window of it drawn from the run's seed, all of its
planes (each reading is the RMS gap over the reference's RMS, worst part,
or a count of rows that differ):

* ``pyramid_rel_rms``: p2..p6;
* ``rpn_rel_rms``: the objectness logits and the box deltas;
* ``head_rel_rms``: the class logits and box deltas of the program's valid
  proposals, against the reference's RoIAlign and head over the
  reference's pyramid at those proposals;
* ``proposal_mismatch_pct``: the reference's proposal stage on the
  program's RPN outputs against the program's valid proposals, rows without
  a counterpart in % of both sides' rows;
* ``detection_mismatch_pct``: the reference's box stage on the program's
  proposals and head outputs against the program's detections (box, label
  and score), the same way;
* ``merge_mismatch``: on the whole request, the reference's merge of the
  program's per-plane detections against the request's answer, rows
  without a counterpart.

Every discrete stage's limit is 0: on the program's own inputs the
reference's stages give the same rows on every run measured.  Also
reported, not compared: ``mean_valid_proposals`` and ``mean_detections`` a
plane of the window, ``merged_candidates`` of the request, and
``calibration_s``.
"""

from __future__ import annotations

import time

import torch

from portbench.inputs import make_volume, sub_seed
from portbench.reference.precision import Precision

LEVELS = ("p2", "p3", "p4", "p5", "p6")
# a row matches one of the other side within these (pixels; probability)
BOX_TOL = 1e-2
SCORE_TOL = 1e-5


def detector_config(cfg: dict):
    from hcunet_tpu_torch.config import DetectorConfig

    return DetectorConfig(
        num_classes=cfg["num_classes"], max_detections=cfg["box_detections_per_img"],
        anchor_sizes=tuple(cfg["anchor_sizes"]), anchor_ratios=tuple(cfg["anchor_ratios"]),
        rpn_pre_nms_top_n=cfg["rpn_pre_nms_top_n"],
        rpn_post_nms_top_n=cfg["rpn_post_nms_top_n"], rpn_nms_thresh=cfg["rpn_nms_thresh"],
        box_score_thresh=cfg["box_score_thresh"], box_nms_thresh=cfg["box_nms_thresh"],
        roi_align_output=cfg["roi_align_output"])


def weights(run, volumes=None) -> dict:
    """The detector's weights of the run, made once a run: the drawn ones
    completed by the reference, the background bias calibrated on the
    first window of every request of the pool, each weighted by the number
    of windows its request runs, so that every depth and size the window
    sends counts as often as the merge will see it.  ``volumes`` (the
    pool's, by request index) spares making them again; the seconds it took
    are kept as ``run.calibration_s``."""
    if getattr(run, "detector_weights", None) is None:
        t0 = time.perf_counter()
        cfg, windows, shares = run.config, [], []
        for item in sorted(run.requests, key=lambda r: r.index):
            image = (volumes[item.index] if volumes is not None
                     else make_volume(item.shape, item.seed, run.device))
            grid = run.reference.tile_grid(cfg, *item.shape[:2])
            x0, x1, y0, y1 = grid[0]
            windows.append(image[x0:x1, y0:y1][..., list(cfg["detection_channels"])]
                           .movedim(2, 0).contiguous())
            shares.append(len(grid))
            del image
        run.detector_weights = run.reference.detector_weights(
            run.weights, cfg, windows, Precision("float32", run.device), shares)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        run.calibration_s = time.perf_counter() - t0
    return run.detector_weights


def build_model(run, volumes=None):
    """The program's detector on the run's device with the benchmark's
    weights (``volumes`` as :func:`weights` takes them)."""
    from hcunet_tpu_torch.models.detection import Detector

    det = Detector(detector_config(run.config), backbone=run.config["backbone"],
                   backbone_width=run.config["width"], device=run.device)
    state = det.state_dict()
    state.update(weights(run, volumes))
    det.load_state_dict(state)
    return det.eval()


def counters(state) -> dict:
    from hcunet_tpu_torch.ops.nms import NMS_STEPS

    return {"nms_steps": NMS_STEPS.launches}


def setup(run):
    # the step counter first: a program without it fails here, before the
    # volumes are made
    counters(None)
    volumes = {r.index: make_volume(r.shape, r.seed, run.device) for r in run.requests}
    tiles = run.config["tiles"]
    state = {"detector": build_model(run, volumes), "volumes": volumes, "device": run.device,
             "channels": list(run.config["detection_channels"]),
             "eval_size": tuple(tiles["eval_size"]), "pad": tuple(tiles["pad"])}
    depths = set()
    for item in run.requests:
        if item.shape[2] not in depths:
            depths.add(item.shape[2])
            request(state, item)
    return state


def _image(state, item):
    """The detector's channels of the request's volume, sliced on the card
    as ``analyze`` slices them."""
    return state["volumes"][item.index][..., state["channels"]]


def request(state, item):
    from hcunet_tpu_torch.infer.detect import predict_cell_candidates

    return predict_cell_candidates(_image(state, item), state["detector"],
                                   eval_size=state["eval_size"], pad=state["pad"],
                                   device=state["device"])


def release(state) -> None:
    """Nothing: the check runs the program's stages again."""


def k1_launches(run, item):
    """The detector runs no K1 launch."""
    return []


# --- the comparisons -------------------------------------------------------------


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.double() - want.double()).pow(2).mean().sqrt()
    return float(d / want.double().pow(2).mean().sqrt().clamp_min(1e-30))


def unmatched(got: dict, want: dict, keys=()) -> tuple:
    """Rows of ``got`` and of ``want`` (dicts of ``boxes`` [n, 4] and the
    other ``keys``) with no row of the other side within ``BOX_TOL`` of its
    box, ``SCORE_TOL`` of its score, and equal in ``labels`` and
    ``z_level``; with the two sides' row counts."""
    n, m = got["boxes"].shape[0], want["boxes"].shape[0]
    if not n or not m:
        return n, m, n, m
    dev = want["boxes"].device
    got = {k: got[k].to(dev) for k in ("boxes", *keys)}
    close = torch.zeros((n, m), dtype=torch.bool, device=dev)
    for rows in torch.arange(n, device=dev).split(2048):
        c = (got["boxes"][rows, None].float()
             - want["boxes"][None].float()).abs().amax(-1) <= BOX_TOL
        for k in keys:
            a, b = got[k][rows, None], want[k][None]
            if k == "scores":
                c &= (a.double() - b.double()).abs() <= SCORE_TOL
            else:
                c &= a.double() == b.double()
        close[rows] = c
    return int((~close.any(1)).sum()), int((~close.any(0)).sum()), n, m


def mismatch_pct(pairs, keys=()) -> float:
    """Rows without a counterpart over all rows of both sides, in %, over
    the ``(got, want)`` pairs."""
    a = b = n = m = 0
    for got, want in pairs:
        ua, ub, na, nb = unmatched(got, want, keys)
        a, b, n, m = a + ua, b + ub, n + na, m + nb
    return 100.0 * (a + b) / max(n + m, 1)


def plane_detections(out) -> list:
    """The program's ``[B, K, ...]`` detections as each plane's valid rows."""
    if isinstance(out, list):
        return out
    return [{"boxes": out["boxes"][b][v], "scores": out["scores"][b][v],
             "labels": out["labels"][b][v]} for b, v in enumerate(out["valid"])]


def window_numbers(run, W, got: dict, planes: torch.Tensor) -> dict:
    """The readings of one window's ``planes`` [B, H, W, 3] against the
    reference, from ``got``, the stages of the side under test (the
    program's ``Detector.detect_stages`` or the reference's ``stages``)."""
    ref, cfg = run.reference, run.config
    P = Precision("float32", run.device)
    hw = tuple(planes.shape[1:3])
    pyramid, rpn = ref.trunk(W, cfg, planes, P)
    numbers = {"pyramid_rel_rms": max(rel_rms(got["pyramid"][lvl], pyramid[lvl])
                                      for lvl in LEVELS)}
    numbers["rpn_rel_rms"] = max(
        rel_rms(torch.cat([got["rpn"][lvl][i].flatten() for lvl in LEVELS]),
                torch.cat([rpn[lvl][i].flatten() for lvl in LEVELS])) for i in (0, 1))
    props, valid = got["proposals"], got["proposal_valid"]
    want, want_valid = ref.proposals(cfg, got["rpn"], hw)
    numbers["proposal_mismatch_pct"] = mismatch_pct(
        ({"boxes": props[b][valid[b]]}, {"boxes": want[b][want_valid[b]]})
        for b in range(props.shape[0]))
    img = torch.arange(props.shape[0], device=props.device)[:, None].expand_as(valid)[valid]
    logits, deltas = ref.head(W, cfg, pyramid, props[valid], img, P)
    numbers["head_rel_rms"] = max(rel_rms(got["class_logits"][valid], logits),
                                  rel_rms(got["box_deltas"][valid], deltas))
    dets = plane_detections(got["detections"])
    want = ref.detections(cfg, props, valid, got["class_logits"], got["box_deltas"], hw)
    numbers["detection_mismatch_pct"] = mismatch_pct(zip(dets, want), ("scores", "labels"))
    numbers["mean_valid_proposals"] = float(valid.sum()) / valid.shape[0]
    numbers["mean_detections"] = sum(d["boxes"].shape[0] for d in dets) / len(dets)
    return numbers


def _window(run, X: int, Y: int):
    grid = run.reference.tile_grid(run.config, X, Y)
    return grid[sub_seed(run.seed, "window") % len(grid)]


def check(run, state) -> dict:
    from hcunet_tpu_torch.core.precision import exact_float32
    from hcunet_tpu_torch.infer.detect import dispatch_cell_candidates

    item, answer = run.sampled()[0]
    det, image = state["detector"], _image(state, item)
    W = weights(run)
    x0, x1, y0, y1 = _window(run, *image.shape[:2])
    planes = image[x0:x1, y0:y1].movedim(2, 0)
    with exact_float32():
        got = det.detect_stages(planes)
    numbers = window_numbers(run, W, got, planes)
    del got
    pending = dispatch_cell_candidates(image, det, state["eval_size"], state["pad"],
                                       device=state["device"])
    want = run.reference.merge(run.config, [((p[0], p[2]), plane_detections(p[5]))
                                            for p in pending])
    got = {k: torch.as_tensor(v) for k, v in answer.items()}
    ua, ub, _, _ = unmatched(got, want, ("scores", "labels", "z_level"))
    numbers["merge_mismatch"] = float(ua + ub)
    numbers["merged_candidates"] = float(got["boxes"].shape[0])
    numbers["calibration_s"] = float(getattr(run, "calibration_s", 0.0))
    return numbers


def control(run, precision: str) -> dict:
    """The numbers of the reference in ``precision`` put in the program's
    place, on the first request of the pool (its window drawn as the
    check's).  Its discrete stages are the reference's own, so they read 0,
    the merge without being run."""
    item = run.requests[0]
    cfg = run.config
    image = make_volume(item.shape, item.seed, run.device)[..., list(cfg["detection_channels"])]
    W = weights(run)
    x0, x1, y0, y1 = _window(run, *image.shape[:2])
    planes = image[x0:x1, y0:y1].movedim(2, 0)
    got = run.reference.stages(W, cfg, planes, Precision(precision, run.device))
    numbers = window_numbers(run, W, got, planes)
    numbers["merge_mismatch"] = 0.0
    return numbers
