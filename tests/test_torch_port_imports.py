"""The PyTorch port stands alone: no JAX, no JAX package, and no quiet move
to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.config import DetectorConfig, UNetConfig, WatershedConfig, resolve_device
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.detect import predict_cell_candidates
from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.infer.tiling import (
    predict_segmentation_mask,
    predict_segmentation_mask_reference_grid,
)
from hcunet_tpu_torch.models.detection import Detector
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv3d_valid
from hcunet_tpu_torch.ops.distance import EDT_PASS, edt

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import hcunet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hcunet_tpu_torch.__path__, "hcunet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(k for k in sys.modules
                if k in ("jax", "msgpack", "optax", "hcunet_tpu")
                or k.startswith(("jax.", "jaxlib", "flax", "msgpack.", "optax.", "hcunet_tpu.", "hcat")))
print(len(names), leaked)
assert len(names) >= 60, names
for n in ("train.losses", "train.trainer", "train.targets", "train.parity", "utils.checkpoint",
          "utils._flax_msgpack", "core.rng", "data.datasets", "data.transforms",
          "cli", "compat", "apps.batch", "analysis.validate", "utils.profiling",
          "models.runet", "models.rdcnet", "infer.compile_recurrent", "infer.vector_cluster",
          "ops.peaks", "train.detection_trainer", "train.pretrain", "analysis.detection_metrics",
          "core.precision", "parallel", "parallel.mesh", "parallel.spatial", "parallel.tiled",
          "parallel.train"):
    assert "hcunet_tpu_torch." + n in names, n
assert not leaked, leaked
"""


def test_port_imports_no_jax_or_jax_package():
    """Import every module of the port in a fresh interpreter (this one has
    JAX loaded by conftest), the training slice's, the entry points'
    (command line, facade, batch, validation, profiling) and the recurrent
    family's (models, serving forward, host clustering) among them, and
    check that neither JAX, flax, optax, msgpack nor the JAX package came
    with it; the detection and recurrent training (detection trainer,
    backbone pretraining, detection metrics) and the multi-device package
    (``parallel``: mesh, sharded inference and training) among them."""
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
    before_routes = dict(CONV3D_VALID.route_launches)
    assert conv3d_valid(x, w).shape == (1, 3, 3, 3, 8)
    # bf16 with Cin % 8 == 0 (the ring path's inputs) too
    xb = torch.zeros((1, 5, 5, 4, 16), dtype=torch.bfloat16)
    wb = torch.zeros((3, 3, 2, 16, 16), dtype=torch.bfloat16)
    assert conv3d_valid(xb, wb).shape == (1, 3, 3, 3, 16)
    assert CONV3D_VALID.launches == before
    assert CONV3D_VALID.route_launches == before_routes
    with pytest.raises(ValueError, match="no kernel"):
        conv3d_valid(x.to("meta"), w.to("meta"))


def test_segmenter_mesh_and_checkpoint_not_ported(tmp_path):
    """``mesh=`` needs a ``spatial`` axis to shard over (slice 12); the
    checkpoint format (slice 8): ``from_checkpoint`` reads a checkpoint the
    port wrote and raises on a missing file."""
    from hcunet_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from hcunet_tpu_torch.utils.checkpoint import save_checkpoint
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict

    cfg, model = _tiny()
    with pytest.raises(ValueError, match="spatial"):
        Segmenter(model, device="cpu", mesh=make_mesh({DATA_AXIS: 2}, ["cpu"] * 2))
    with pytest.raises(FileNotFoundError):
        Segmenter.from_checkpoint(str(tmp_path / "model.hcunet"), device="cpu")
    path = str(tmp_path / "tiny.hcunet")
    save_checkpoint(path, jax_variables_from_unet_state_dict(model.state_dict(), cfg), cfg,
                    snapshot_sources=False)
    seg = Segmenter.from_checkpoint(path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(seg.model.state_dict()[k], v), k


_SMALL_DET = DetectorConfig(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8, max_detections=4)
_CAND = {
    "boxes": np.asarray([[4, 4, 12, 12]], np.float32),
    "scores": np.asarray([0.9], np.float32),
    "labels": np.asarray([1], np.int32),
    "z_level": np.asarray([1.0], np.float32),
}


@pytest.mark.parametrize(
    "entry", ["detector", "predict_cell_candidates", "generate_unique_segmentation_mask"]
)
def test_slice2_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    det_cpu = Detector(_SMALL_DET, backbone="small", device="cpu")
    vol = np.zeros((64, 64, 2, 3), np.float32)
    mask = np.zeros((16, 16, 3), np.uint8)
    mask[2:14, 2:14] = 1
    ws = WatershedConfig(backend="device", expand_mask=1, device_iters=4)
    calls = {
        "detector": lambda **kw: Detector(_SMALL_DET, backbone="small", **kw),
        "predict_cell_candidates": lambda **kw: predict_cell_candidates(
            vol, det_cpu, **kw
        ),
        "generate_unique_segmentation_mask": lambda **kw: generate_unique_segmentation_mask(
            mask, _CAND, ws, **kw
        ),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](device="cuda")
    calls[entry](device="cpu")  # the CPU only when asked for


def test_edt_takes_plain_version_only_on_cpu():
    b = torch.ones((6, 5, 2))
    b[0, 0] = 0
    before = EDT_PASS.launches
    assert edt(b, axes=(0, 1)).shape == (6, 5, 2)
    assert EDT_PASS.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        edt(b.to("meta"), axes=(0, 1))


@pytest.mark.parametrize("backend", ["fused", "materialized"])
def test_host_watershed_backends_not_ported(no_cuda, backend):
    """The host backends are ported now (the host flood of
    ``ops/watershed.py``): they run on the host, so they need no card and
    no ``device=`` even where CUDA is absent."""
    mask = np.zeros((16, 16, 3), np.uint8)
    mask[2:14, 2:14] = 1
    labels, seeds = generate_unique_segmentation_mask(
        mask, _CAND, WatershedConfig(backend=backend, expand_mask=1)
    )
    assert labels.shape == seeds.shape == mask.shape
    assert labels.dtype == seeds.dtype == np.int32
    with pytest.raises(ValueError, match="unknown watershed backend"):
        generate_unique_segmentation_mask(mask, _CAND, WatershedConfig(backend="other"))


@pytest.mark.parametrize("entry", ["compile_recurrent_apply", "compile_rdcnet_apply",
                                   "recurrent_model"])
def test_recurrent_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.infer.compile_recurrent import (
        compile_rdcnet_apply,
        compile_recurrent_apply,
    )
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.utils.checkpoint import recurrent_model
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_runet_state_dict

    runet = RecursiveUNet(RUNetConfig(timesteps=1)).eval()
    calls = {
        "compile_recurrent_apply": lambda **kw: compile_recurrent_apply(runet, **kw),
        "compile_rdcnet_apply": lambda **kw: compile_rdcnet_apply(
            RDCNet(RDCNetConfig(timesteps=1)).eval(), **kw),
        "recurrent_model": lambda **kw: recurrent_model(
            runet.config, jax_variables_from_runet_state_dict(runet.state_dict()), **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](device="cuda")
    calls[entry](device="cpu")  # the CPU only when asked for
