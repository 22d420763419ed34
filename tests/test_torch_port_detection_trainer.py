"""``DetectionTrainer`` of the PyTorch port against the JAX one, on the
CPU, over 3 optimizer steps from the same weights: ``train_step`` (B=1)
with the per-epoch exponential decay and ``train_step_batch`` (B=2) with
the warmup-cosine schedule.  The set-up (the small backbone at width 8, 64
x 64 images, 3 boxes padded to 6) is ``test_torch_port_detection_train.py``'s.

Tolerances: each step's loss within 1e-4 relative (the two sides' float32
rounding, carried through Adam's steps), the learning rate equal to the
optax schedule's, and the variables after the steps as
``assert_trajectories_match`` holds them (``train/parity.py``); the small
lr (1e-4) keeps Adam's rounding-sized steps from moving the proposals.
"""

import jax
import numpy as np
import optax
import pytest

from hcunet_tpu.train.detection_trainer import DetectionTrainConfig as JaxDetectionTrainConfig
from hcunet_tpu.train.detection_trainer import DetectionTrainer as JaxDetectionTrainer
from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer
from tests.test_torch_port_detection_train import BOXES, LABELS, MAX_GT, detector_pair, image
from tests.torch_port_support import assert_trajectories_match

LR = 1e-4
CASES = {
    "exp_b1": dict(batch=1, cfg=dict(gamma=0.5), steps_per_epoch=2),
    "cosine_b2": dict(batch=2, cfg=dict(schedule="cosine", warmup_steps=1, total_steps=4),
                      steps_per_epoch=1),
}


def _as_one_tree(v):
    """The detector's ``{"trunk", "head"}`` tree as ``{"params",
    "batch_stats"}``, the form ``train/parity.py`` compares."""
    return {"params": {"trunk": v["trunk"]["params"], "head": v["head"]["params"]},
            "batch_stats": {"trunk": v["trunk"]["batch_stats"]}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detection_trainer_matches_jax(case):
    spec = CASES[case]
    jdet, variables, tdet = detector_pair()
    kw = dict(learning_rate=LR, max_gt=MAX_GT, **spec["cfg"])
    jt = JaxDetectionTrainer(jdet, variables, JaxDetectionTrainConfig(**kw),
                             steps_per_epoch=spec["steps_per_epoch"], batch_size=spec["batch"])
    pt = DetectionTrainer(tdet, None, DetectionTrainConfig(**kw),
                          steps_per_epoch=spec["steps_per_epoch"], batch_size=spec["batch"],
                          device="cpu")
    if kw.get("schedule") == "cosine":
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 4)
    else:
        sched = optax.exponential_decay(LR, 2, 0.5, staircase=True)
    target = {"boxes": BOXES, "labels": LABELS}
    for step in range(3):
        assert pt.opt.param_groups[0]["lr"] == pytest.approx(float(sched(step)), rel=1e-6, abs=1e-12)
        if spec["batch"] == 1:
            img = image(10 + step)
            lj = jt.train_step(img, BOXES, LABELS)
            lp = pt.train_step(img, BOXES, LABELS)
        else:
            imgs = np.concatenate([image(10 + step), image(20 + step)])
            lj = jt.train_step_batch(imgs, [target, target])
            lp = pt.train_step_batch(imgs, [target, target])
        assert abs(lp - lj) <= 1e-4 * abs(lj), (step, lp, lj)
        assert set(pt.last_losses) == {"loss_objectness", "loss_rpn_box_reg",
                                       "loss_classifier", "loss_box_reg"}
    want = _as_one_tree(jax.tree.map(np.asarray, jt.variables))
    assert_trajectories_match(_as_one_tree(pt.variables), want, _as_one_tree(variables), LR, 3)
