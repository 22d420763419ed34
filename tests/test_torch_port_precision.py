"""Fault F4's repair: the library computes float32 in float32.

Each entry point's float32 work runs inside
``hcunet_tpu_torch.core.precision.exact_float32``, which turns TF32 off for
the call and gives the caller's settings back after it.  A conv that
records the two flags while it runs shows them off inside the call; after
it they are what the caller set."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hcunet_tpu_torch.config import TileConfig, UNetConfig
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer
from tests.torch_port_support import SMALL, train_batch


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (torch's defaults are on for cuDNN), restored
    after the test, and every ``F.conv3d`` recording the flags it ran
    under."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    conv3d = F.conv3d

    def recording(*args, **kwargs):
        seen.append(_flags())
        return conv3d(*args, **kwargs)

    monkeypatch.setattr(F, "conv3d", recording)
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


@pytest.mark.parametrize("entry", ["segmenter_predict", "unet_train_step"])
def test_library_float32_runs_without_tf32(tf32_on, entry):
    cfg = UNetConfig(**SMALL)
    model = init_unet(cfg, torch.Generator().manual_seed(0))
    if entry == "segmenter_predict":
        seg = Segmenter(model, tile_cfg=TileConfig(eval_size=(16, 16, 6), pad=(16, 16, 2),
                                                   batch=1),
                        dtype=torch.float32, device="cpu")
        seg.predict(np.random.default_rng(0).random((24, 24, 6, 4), np.float32))
    else:
        trainer = UNetTrainer(model, None, TrainConfig(), device="cpu")
        trainer.train_step(*train_batch())
    assert tf32_on and set(tf32_on) == {(False, False)}
    assert _flags() == (True, True)
