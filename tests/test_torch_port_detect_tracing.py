"""The detection path's tracing: ``NMS_STEPS`` (``ops/nms.py``) counts the
steps of ``nms_mask``'s fixed point, and ``predict_cell_candidates`` opens
``hcunet.detect.tiles``, ``hcunet.detect.nms`` and ``hcunet.detect.merge``
under a profiler; ``Detector.detect_stages`` keeps each stage of
``detect``.  On the CPU at small sizes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hcunet_tpu_torch.config import DetectorConfig
from hcunet_tpu_torch.infer.detect import predict_cell_candidates
from hcunet_tpu_torch.models.detection import LEVELS, Detector
from hcunet_tpu_torch.ops.nms import NMS_STEPS, nms_mask

# 31 x 31 windows at (0, 24, 32) on each axis of a 64 x 64 plane
TILES = dict(eval_size=(24, 24), pad=(4, 4))
WINDOWS = 9


def _chain(n, rng):
    """``n`` boxes in a row, each overlapping the next at IoU 0.25 and no
    other, scores falling along the row, in shuffled input order."""
    i = np.arange(n, dtype=np.float32)
    boxes = np.stack([6 * i, 0 * i, 6 * i + 10, 0 * i + 10], 1)
    scores = 1.0 - 0.01 * i
    perm = rng.permutation(n)
    return torch.from_numpy(boxes[perm]), torch.from_numpy(scores[perm]), perm


def _steps(*args):
    before = NMS_STEPS.launches
    keep = nms_mask(*args)
    return keep, NMS_STEPS.launches - before


@pytest.mark.parametrize("n", [1, 2, 3, 7, 20])
def test_nms_steps_count_a_suppression_chain(n):
    """In a chain every kept box's successor is suppressed and the one after
    it kept again: after step t the first t boxes are settled and the rest
    of the row flips, so the loop reads the flag n times."""
    boxes, scores, perm = _chain(n, np.random.default_rng(n))
    keep, steps = _steps(boxes, scores, 0.2)
    assert keep.tolist() == [bool(p % 2 == 0) for p in perm]
    assert steps == n


def test_nms_steps_over_a_batch_and_without_overlaps():
    """A batch runs one loop, as long as its longest chain; boxes that
    overlap nothing settle at once (one step); an empty list reads no
    flag."""
    rng = np.random.default_rng(0)
    b5, s5, _ = _chain(5, rng)
    b3, s3, _ = _chain(3, rng)
    boxes = torch.stack([b5, torch.cat([b3, torch.zeros(2, 4)])])
    scores = torch.stack([s5, torch.cat([s3, torch.full((2,), -torch.inf)])])
    keep, steps = _steps(boxes, scores, 0.2)
    assert steps == 5 and keep.sum(1).tolist() == [3, 2]
    apart = torch.tensor([[0.0, 0, 5, 5], [10, 10, 15, 15], [20, 0, 25, 5]])
    keep, steps = _steps(apart, torch.tensor([0.3, 0.2, 0.1]), 0.5)
    assert keep.all() and steps == 1
    _, steps = _steps(torch.zeros(0, 4), torch.zeros(0), 0.5)
    assert steps == 0


@pytest.fixture(scope="module")
def detector():
    torch.manual_seed(0)
    cfg = DetectorConfig(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, max_detections=16,
                         anchor_sizes=(8, 16, 32, 64, 128), box_score_thresh=0.3)
    return Detector(cfg, backbone="small", device="cpu")


def _volume():
    return np.random.default_rng(4).random((64, 64, 2, 3), dtype=np.float32)


def _detect(det):
    return predict_cell_candidates(_volume(), det, device="cpu", **TILES)


def test_detect_stages_keep_what_detect_returns(detector):
    planes = np.random.default_rng(5).random((2, 40, 48, 3), dtype=np.float32)
    stages = detector.detect_stages(planes)
    want = detector.detect(planes)
    for k, v in want.items():
        assert torch.equal(stages["detections"][k], v), k
    assert set(stages["pyramid"]) == set(LEVELS) == set(stages["rpn"])
    n = stages["proposals"].shape[1]
    assert stages["proposals"].shape == (2, n, 4) and stages["proposal_valid"].shape == (2, n)
    assert stages["class_logits"].shape == (2, n, 3)
    assert stages["box_deltas"].shape == (2, n, 12)


def test_detect_spans_and_steps(detector):
    """``predict_cell_candidates`` under the profiler: one tiles span holding
    the six NMS calls of each window (five levels of proposals, then the
    boxes), then one merge span with none; the steps the counter adds are
    the same with and without the profiler, and so are the candidates."""
    before = NMS_STEPS.launches
    want = _detect(detector)
    untraced = NMS_STEPS.launches - before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _detect(detector)
    assert NMS_STEPS.launches - before == 2 * untraced >= 6 * WINDOWS
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(want["scores"]) > 0
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("hcunet.")), key=lambda s: (s[1], -s[2]))
    names = [s[0] for s in spans]
    assert names.count("hcunet.detect.tiles") == names.count("hcunet.detect.merge") == 1
    tiles = spans[names.index("hcunet.detect.tiles")]
    merge = spans[names.index("hcunet.detect.merge")]
    inner = [s for s in spans if s[0] == "hcunet.detect.nms"]
    assert len(inner) == 6 * WINDOWS
    assert all(tiles[1] <= s[1] and s[2] <= tiles[2] for s in inner)
    assert tiles[2] <= merge[1]


def test_detect_enters_no_record_function_without_a_profiler(detector, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _detect(detector)
