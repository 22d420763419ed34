"""Faults F4 and F6 repaired: the library computes float32 in float32.

Each entry point's float32 work runs inside
``hcunet_tpu_torch.core.precision.exact_float32``, which turns TF32 off for
the call and gives the caller's settings back after it.  A conv (``F.conv3d``
for the U-Net, ``F.conv2d`` for the detector) that records the two flags
while it runs shows them off inside the call; after it they are what the
caller set."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hcunet_tpu_torch.analysis.validate import validate_segmentation
from hcunet_tpu_torch.config import DetectorConfig, TileConfig, UNetConfig
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.detect import (
    ShardedDetect,
    dispatch_cell_candidates,
    predict_cell_candidates,
)
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.infer.tiling import (
    predict_segmentation_mask,
    predict_segmentation_mask_reference_grid,
)
from hcunet_tpu_torch.models.detection import Detector
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.parallel.mesh import make_mesh
from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer
from tests.torch_port_support import SMALL, train_batch


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (torch's defaults are on for cuDNN), restored
    after the test, and every ``F.conv3d`` and ``F.conv2d`` recording the
    flags it ran under."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def recording(conv):
        def call(*args, **kwargs):
            seen.append(_flags())
            return conv(*args, **kwargs)
        return call

    monkeypatch.setattr(F, "conv3d", recording(F.conv3d))
    monkeypatch.setattr(F, "conv2d", recording(F.conv2d))
    return seen


def test_exact_float32_restores_the_callers_settings(monkeypatch):
    for cudnn, matmul in ((True, True), (True, False), (False, True)):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
        with exact_float32():
            assert _flags() == (False, False)
            with exact_float32():
                assert _flags() == (False, False)
            assert _flags() == (False, False)
        assert _flags() == (cudnn, matmul)
    with pytest.raises(KeyError), exact_float32():
        raise KeyError("restored on the way out too")
    assert _flags() == (False, True)


_TILES = TileConfig(eval_size=(16, 16, 6), pad=(16, 16, 2), batch=1)
_SMALL_DET = DetectorConfig(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8, max_detections=4)


def _detector():
    return Detector(_SMALL_DET, backbone="small", device="cpu")


def _unet_entry(entry, model, cfg):
    """One U-Net entry point on a small float32 volume on the CPU."""
    vol = np.random.default_rng(0).random((1, 24, 24, 6, 4), np.float32)
    if entry == "segmenter_predict":
        Segmenter(model, tile_cfg=_TILES, dtype=torch.float32, device="cpu").predict(vol[0])
        return
    if entry == "unet_train_step":
        UNetTrainer(model, None, TrainConfig(), device="cpu").train_step(*train_batch())
        return
    apply = compile_serving_apply(model, dtype=torch.float32, device="cpu")
    if entry == "predict_segmentation_mask":
        predict_segmentation_mask(apply, vol, cfg, _TILES, device="cpu")
    elif entry == "predict_segmentation_mask_reference_grid":
        predict_segmentation_mask_reference_grid(apply, vol, cfg, _TILES, device="cpu")
    else:  # validate_segmentation, on a one-sample Stack-style dataset
        mask = (vol[..., :1] > 0.5).astype(np.float32)
        validate_segmentation(apply, [(vol, mask, None)], cfg, _TILES, device="cpu")


def _detector_entry(entry):
    """One detection entry point on a small float32 z-stack on the CPU."""
    vol = np.random.default_rng(0).random((64, 64, 2, 3), np.float32)
    if entry == "predict_cell_candidates":
        predict_cell_candidates(vol, _detector(), device="cpu")
    elif entry == "dispatch_cell_candidates":
        dispatch_cell_candidates(vol, _detector(), device="cpu")
    else:  # ShardedDetect.detect over two CPU entries
        sharded = ShardedDetect(_detector(), make_mesh({"spatial": 2}, ["cpu"] * 2))
        sharded.detect(np.moveaxis(vol, 2, 0).copy())


UNET_ENTRIES = ["segmenter_predict", "unet_train_step", "predict_segmentation_mask",
                "predict_segmentation_mask_reference_grid", "validate_segmentation"]
DETECTOR_ENTRIES = ["predict_cell_candidates", "dispatch_cell_candidates",
                    "sharded_detect"]


@pytest.mark.parametrize("entry", UNET_ENTRIES + DETECTOR_ENTRIES)
def test_library_float32_runs_without_tf32(tf32_on, entry):
    if entry in DETECTOR_ENTRIES:
        _detector_entry(entry)
    else:
        cfg = UNetConfig(**SMALL)
        _unet_entry(entry, init_unet(cfg, torch.Generator().manual_seed(0)), cfg)
    assert tf32_on and set(tf32_on) == {(False, False)}
    assert _flags() == (True, True)
