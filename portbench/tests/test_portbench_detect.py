"""The detector's cell at a small size on the CPU: the program against the
plain reference ``reference/frcnn-r50fpn-hcat.py`` stage by stage, whole
runs of the cell, a program altered at one stage driving ``correct`` to
false, the TF32 control failing the check, the cell's metrics reading
numbers, the frozen FLOP count, and a program without the step counter
failing at once.

The configuration keeps every published width (ResNet-50 at width 64, the
FPN's 256 channels, the 1024-wide head) on two planes of 96 x 96; the tile
core is cut to 40 with a halo of 8 so that a plane holds 2 x 2 windows, one
of them repeated (as 2048 is at the real size), and 300 proposals are kept
after NMS so that RoIAlign fits the CPU's memory; the background bias is
calibrated to keep 20 merged candidates a window of these small sizes."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bench, flops_detect, trace as tracing
from portbench.control import control_numbers
from portbench.inputs import make_volume, make_weights
from portbench.reference.precision import Precision
from portbench.tests.conftest import ROOT

CELL = "frcnn-f32-detect-chunks"
REF = bench.load_module(bench.reference_path("frcnn-r50fpn-hcat"))
CFG = {**json.loads((ROOT / "portbench/configs/frcnn-r50fpn-hcat.json").read_text()),
       "tiles": {"eval_size": [40, 40], "pad": [8, 8]}, "rpn_post_nms_top_n": 300,
       "merged_target": 20}
SMALL = {"config": {k: CFG[k] for k in ("tiles", "rpn_post_nms_top_n", "merged_target")},
         "mix": {"shape": [96, 96, 2], "pool": 2, "trace_requests": 1}}
SEED = 2**31 + 77
F32 = Precision("float32", "cpu")


@pytest.fixture(scope="module")
def program():
    """The program's detector and the reference's weights, on the CPU."""
    from portbench.entries.detect_chunk import build_model

    W = REF.detector_weights(make_weights(REF.param_specs(CFG), 11, "cpu"), CFG, [_planes()], F32)
    run = SimpleNamespace(config=CFG, device=torch.device("cpu"), detector_weights=W)
    return build_model(run), W


def _planes():
    return make_volume((96, 96, 2), 12, "cpu")[..., [0, 2, 3]].movedim(2, 0)


def _rel(got, want):
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def test_the_program_matches_the_reference_stage_by_stage(program):
    """Pyramid, RPN and head to float32 rounding; the proposals, the
    detections and the merged candidates of a volume the same rows."""
    from hcunet_tpu_torch.infer.detect import predict_cell_candidates
    from portbench.entries.detect_chunk import plane_detections

    det, W = program
    planes = _planes()
    got = det.detect_stages(planes)
    want = REF.stages(W, CFG, planes, F32)
    for lvl in REF.LEVELS:
        assert _rel(got["pyramid"][lvl], want["pyramid"][lvl]) < 1e-5, lvl
        for i in (0, 1):
            assert _rel(got["rpn"][lvl][i], want["rpn"][lvl][i]) < 1e-5, lvl
    v = got["proposal_valid"]
    assert torch.equal(v, want["proposal_valid"]) and int(v.sum()) > 0
    torch.testing.assert_close(got["proposals"][v], want["proposals"][v], rtol=0, atol=1e-3)
    assert _rel(got["class_logits"][v], want["class_logits"][v]) < 1e-5
    assert _rel(got["box_deltas"][v], want["box_deltas"][v]) < 1e-5
    dets = plane_detections(got["detections"])
    assert sum(d["boxes"].shape[0] for d in dets) > 0
    for g, w in zip(dets, want["detections"]):
        assert g["boxes"].shape == w["boxes"].shape
        torch.testing.assert_close(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        torch.testing.assert_close(g["scores"], w["scores"], rtol=0, atol=1e-5)
        assert torch.equal(g["labels"], w["labels"])
    image = make_volume((96, 96, 2), 13, "cpu")[..., [0, 2, 3]]
    cands = predict_cell_candidates(image, det, device="cpu",
                                    eval_size=(40, 40), pad=(8, 8))
    ref = REF.detect_chunk(W, CFG, image, F32)
    assert len(cands["scores"]) == len(ref["scores"]) > 0
    for k in ("boxes", "scores", "z_level"):
        np.testing.assert_allclose(cands[k], ref[k].numpy(), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(cands["labels"], ref["labels"].numpy())


def test_the_background_bias_keeps_the_target(program):
    """The calibrated weights keep about ``merged_target`` candidates once
    the calibration planes' detections are merged, and raise the
    background's logit bias alone."""
    det, W = program
    drawn = REF.centred(make_weights(REF.param_specs(CFG), 11, "cpu"))
    changed = [k for k in W if not torch.equal(W[k], drawn[k])]
    assert changed == [f"{REF.CLS}.bias"]
    assert torch.equal(W[f"{REF.CLS}.bias"][1:], drawn[f"{REF.CLS}.bias"][1:])
    kept = REF.stages(W, CFG, _planes(), F32)["detections"]
    assert abs(REF.merge(CFG, [((0, 0), kept)])["scores"].shape[0] - 20) <= 4


def test_the_grid_is_the_programs():
    """The reference's windows are ``dispatch_cell_candidates``'s, repeats
    included (2048 repeats [1000, 2047])."""
    from hcunet_tpu_torch.core.shapes import calculate_indexes

    cfg = json.loads((ROOT / "portbench/configs/frcnn-r50fpn-hcat.json").read_text())
    for n in (1000, 1047, 1048, 1536, 2047, 2048, 2049, 2304, 6144):
        want = [[0, n]] if n < 1048 else calculate_indexes(24, 1000, n, n)
        assert [list(w) for w in REF.axis_windows(24, min(1000, n), n)] == want, n
    assert REF.axis_windows(24, 1000, 2048) == [(0, 1047), (1000, 2047), (1000, 2047)]
    assert len(REF.tile_grid(cfg, 2048, 1536)) == 6


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    result = bench.run_cell(CELL, SEED, 0.1, trace, device="cpu", overrides=SMALL)
    assert result["correct"], result["checks"]
    numbers = result["numbers"]
    assert numbers["mean_valid_proposals"] > 0 and numbers["mean_detections"] > 0
    assert numbers["merged_candidates"] > 0
    if trace:
        assert result["metrics"]["nms_steps_per_request.detect"]["value"] >= 6 * 4
        assert result["metrics"]["mfu_pct.detect"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"mvx_per_s.predict", "setup_s"}


def test_every_metric_reads_a_number(monkeypatch):
    """A traced run with one device event added to its trace: each of the
    cell's five metrics reads a number (on the CPU the trace holds no device
    event, and the device readers return None)."""
    seen = []
    export = tracing.export
    monkeypatch.setattr(tracing, "export", lambda prof: seen.append(export(prof)) or seen[-1])
    result = bench.run_cell(CELL, SEED, 0.1, True, device="cpu", overrides=SMALL)
    (t,) = seen
    t.device.append(("kernel", "k", t.window[0], 1.0))
    cell = bench.resolve(bench.load_spec(), CELL, SMALL)
    run = bench.Run(cell, SEED, "cpu")
    obs = SimpleNamespace(trace=t, run=run, requests=run.requests[: result["attempted"]],
                          counters={"nms_steps": 30})
    read = {m["name"]: bench.load_module(bench.metric_path(m["name"])).read(obs)
            for m in cell.per_layer}
    assert set(read) == {"device_idle_pct.detect", "mfu_pct.detect", "nms_idle_ms.detect",
                         "merge_idle_ms.detect", "nms_steps_per_request.detect"}
    assert all(v is not None and v >= 0 for v in read.values()), read
    assert read["nms_steps_per_request.detect"] == 30 / result["attempted"]


def _fault(monkeypatch, stage):
    """Alter the program at one stage: the FPN's top-down path dropped, the
    box stage's NMS skipped, or the merge made at IoU 0.5."""
    if stage == "fpn_top_down":
        from hcunet_tpu_torch.models import fpn

        monkeypatch.setattr(fpn, "resize_nearest", lambda x, size: torch.zeros(
            (*x.shape[:2], *size), dtype=x.dtype))
    elif stage == "final_nms":
        from hcunet_tpu_torch.models import detection

        nms = detection.nms_mask
        monkeypatch.setattr(detection, "nms_mask", lambda b, s, thr: (
            torch.isfinite(s) if thr == CFG["box_nms_thresh"] else nms(b, s, thr)))
    else:
        from hcunet_tpu_torch.infer import candidates, detect

        merge = candidates.merge_cell_candidates
        monkeypatch.setattr(detect, "merge_cell_candidates",
                            lambda old, new, initial_coords: merge(old, new, initial_coords, 0.5))


@pytest.mark.parametrize("stage", ["fpn_top_down", "final_nms", "merge"])
def test_a_broken_program_is_not_correct(stage, monkeypatch):
    _fault(monkeypatch, stage)
    result = bench.run_cell(CELL, SEED, 0.1, False, device="cpu", overrides=SMALL)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_checks():
    """The reference in TF32 (each conv's and linear layer's operands
    rounded) in the program's place reads at least three times a limit."""
    limits = bench.resolve(bench.load_spec(), CELL).mix["checks"]
    numbers = control_numbers(CELL, SEED, "cpu", SMALL)
    assert any(numbers[k] >= 3 * limits[k] for k in limits), (numbers, limits)
    assert numbers["mean_detections"] > 0


def test_resnet50_body_is_its_published_count():
    """ResNet-50's 4.1 GMAC at 224 x 224, less its 2 MMAC classifier."""
    cfg = json.loads((ROOT / "portbench/configs/frcnn-r50fpn-hcat.json").read_text())
    macs, sizes = flops_detect.body_macs(cfg, 224, 224)
    assert macs == pytest.approx(4.1e9, rel=0.01)
    assert sizes == [(56, 56, 256), (28, 28, 512), (14, 14, 1024), (7, 7, 2048)]
    parts = flops_detect.plane_macs(cfg, 1047, 1047)
    # the pyramid's and the RPN's 3x3 convs over p2 (262 x 262) lead them;
    # the head is 1000 rows of 12544 x 1024 + 1024 x 1024 + 1024 x 15
    assert parts["head"] == 1000 * (12544 * 1024 + 1024 * 1024 + 1024 * 15)
    assert parts["rpn"] > 262 * 262 * 9 * 256 * 256 and parts["fpn"] > parts["rpn"]
    assert flops_detect.windows_flops(cfg, [(1047, 1047)] * 2, 3) == pytest.approx(
        12 * sum(parts.values()))


def test_a_program_without_the_step_counter_fails_at_once(monkeypatch):
    from hcunet_tpu_torch.ops import nms

    monkeypatch.delattr(nms, "NMS_STEPS")
    with pytest.raises(ImportError):
        bench.run_cell(CELL, SEED, 0.1, False, device="cpu", overrides=SMALL)
