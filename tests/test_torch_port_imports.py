"""The PyTorch port stands alone: no JAX, no JAX package, and no quiet move
to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.config import UNetConfig, resolve_device
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.infer.tiling import (
    predict_segmentation_mask,
    predict_segmentation_mask_reference_grid,
)
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv3d_valid

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import hcunet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hcunet_tpu_torch.__path__, "hcunet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(k for k in sys.modules
                if k == "jax" or k.startswith(("jax.", "jaxlib", "flax", "hcunet_tpu.", "hcat"))
                or k == "hcunet_tpu")
print(len(names), leaked)
assert len(names) >= 15, names
assert not leaked, leaked
"""


def test_port_imports_no_jax_or_jax_package():
    """Import every module of the port in a fresh interpreter (this one has
    JAX loaded by conftest) and check that neither JAX nor the JAX package
    came with it."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    cfg = UNetConfig(
        feature_sizes=(8, 16), kernel1=(3, 3, 2), kernel2=(3, 3, 1),
        upsample_kernel=(4, 4, 2), max_pool_kernel=(2, 2, 1),
        upsample_stride=(2, 2, 1), groups=1,
    )
    return cfg, init_unet(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "compile_serving_apply", "segmenter",
     "predict_segmentation_mask", "reference_grid"],
)
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    cfg, model = _tiny()
    vol = np.zeros((1, 24, 24, 8, 4), np.float32)
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "compile_serving_apply": lambda **kw: compile_serving_apply(model, **kw),
        "segmenter": lambda **kw: Segmenter(model, **kw),
        "predict_segmentation_mask": lambda **kw: predict_segmentation_mask(
            lambda t: t[..., :1], vol, cfg, **kw
        ),
        "reference_grid": lambda **kw: predict_segmentation_mask_reference_grid(
            lambda t: t[..., :1], vol, cfg, **kw
        ),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](device="cuda")
    if entry in ("resolve_device", "compile_serving_apply", "segmenter"):
        calls[entry](device="cpu")  # the CPU only when asked for


def test_conv_wrapper_takes_plain_version_only_on_cpu():
    """The plain version is the CPU tensor's path; a tensor on any other
    device gets the kernel or an error, never the plain version."""
    x = torch.zeros((1, 5, 5, 4, 3))
    w = torch.zeros((3, 3, 2, 3, 8))
    before = CONV3D_VALID.launches
    assert conv3d_valid(x, w).shape == (1, 3, 3, 3, 8)
    assert CONV3D_VALID.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        conv3d_valid(x.to("meta"), w.to("meta"))


def test_segmenter_mesh_and_checkpoint_not_ported():
    cfg, model = _tiny()
    with pytest.raises(NotImplementedError):
        Segmenter(model, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        Segmenter.from_checkpoint("model.hcunet")
