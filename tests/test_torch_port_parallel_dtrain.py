"""``DetectionTrainer(mesh=)`` of the PyTorch port: a global batch of 8
images split over the 8 entries of a ``data`` mesh (one image each, through
a copy of the detector whose parameters are differentiable copies of the
trainer's), against the single-device trainer at ``batch_size=8`` and the
JAX ``DetectionTrainer(mesh=)`` (``tests/test_parallel.py``'s case), with
``test_torch_port_detection_trainer.py``'s small-backbone set-up.

Tolerances: each step's loss within 1e-4 relative; the variables after the
steps as ``assert_trajectories_match`` holds them (``train/parity.py``).
"""

import jax
import numpy as np
import pytest
import torch

from hcunet_tpu.train.detection_trainer import DetectionTrainConfig as JaxDetectionTrainConfig
from hcunet_tpu.train.detection_trainer import DetectionTrainer as JaxDetectionTrainer
from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer
from tests.test_torch_port_detection_train import BOXES, LABELS, MAX_GT, detector_pair, image
from tests.test_torch_port_detection_trainer import LR, _as_one_tree
from tests.torch_port_support import assert_trajectories_match, mesh_pair


def test_port_detection_trainer_mesh_matches_single_device():
    port_mesh, jax_mesh = mesh_pair({"data": 8})
    kw = dict(learning_rate=LR, max_gt=MAX_GT, gamma=1.0)
    target = {"boxes": BOXES, "labels": LABELS}
    ds = [(image(30 + i), target) for i in range(16)]  # two global batches of 8

    jdet, variables, tdet = detector_pair()
    tr_mesh = DetectionTrainer(tdet, None, DetectionTrainConfig(**kw), mesh=port_mesh)
    assert tr_mesh.batch_size == 8 and tr_mesh.device == torch.device("cpu")
    got = [tr_mesh.train_step_batch(im, tg) for im, tg in tr_mesh._iter_batches(ds)]
    with pytest.raises(ValueError, match="global batches of 8"):
        tr_mesh.train_step(image(1), BOXES, LABELS)

    tr_single = DetectionTrainer(detector_pair()[2], None, DetectionTrainConfig(**kw),
                                 batch_size=8, device="cpu")
    want = [tr_single.train_step_batch(im, tg) for im, tg in tr_single._iter_batches(ds)]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_trajectories_match(_as_one_tree(tr_mesh.variables), _as_one_tree(tr_single.variables),
                              _as_one_tree(variables), LR, 2)

    jt = JaxDetectionTrainer(jdet, variables, JaxDetectionTrainConfig(**kw), mesh=jax_mesh)
    jl = [jt.train_step_batch(im, tg) for im, tg in jt._iter_batches(ds)]
    np.testing.assert_allclose(got, jl, rtol=1e-4)
    assert_trajectories_match(_as_one_tree(tr_mesh.variables),
                              _as_one_tree(jax.tree.map(np.asarray, jt.variables)),
                              _as_one_tree(variables), LR, 2)


def test_port_detection_trainer_model_axis_slices():
    """On a data 2 × model 2 mesh the trunk's and heads' wide parameters
    live as Cout slices (two per tensor) and their AdamW moments with them;
    the steps equal the single-device ones on the same global batches of
    4."""
    port_mesh, _jax_mesh = mesh_pair({"data": 2, "model": 2})
    kw = dict(learning_rate=LR, max_gt=MAX_GT, gamma=1.0)
    target = {"boxes": BOXES, "labels": LABELS}
    ds = [(image(50 + i), target) for i in range(8)]
    _jdet, variables, tdet = detector_pair()
    tr_mesh = DetectionTrainer(tdet, None, DetectionTrainConfig(**kw),
                               mesh=port_mesh, batch_size=4)
    split = tr_mesh._sharded.params.split
    assert any(d is not None for d in split.values())
    got = [tr_mesh.train_step_batch(im, tg) for im, tg in tr_mesh._iter_batches(ds)]
    sliced = [t for name, ts in tr_mesh._sharded.params.pieces.items() if split[name] is not None
              for t in ts]
    assert all(tr_mesh.opt.state[t]["exp_avg"].shape == t.shape for t in sliced)
    tr_single = DetectionTrainer(detector_pair()[2], None, DetectionTrainConfig(**kw),
                                 batch_size=4, device="cpu")
    want = [tr_single.train_step_batch(im, tg) for im, tg in tr_single._iter_batches(ds)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_trajectories_match(_as_one_tree(tr_mesh.variables), _as_one_tree(tr_single.variables),
                              _as_one_tree(variables), LR, 2)
