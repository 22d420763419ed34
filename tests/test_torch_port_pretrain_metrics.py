"""Backbone pretraining and the detection metrics of the PyTorch port
against the JAX package, on the CPU: ``synthetic_shapes_batch`` (the same
images from the same seed, exactly), ``pretrain_backbone`` (3 Adam steps
from the JAX classifier's initial weights, held by
``assert_trajectories_match``), ``save_backbone``/``load_backbone`` (flax's
bytes, both ways), ``seed_detector_backbone`` (the same tree, the same
``ValueError``) and ``evaluate_detections`` (the JAX tests' four cases and
seeded detections, exactly).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from hcunet_tpu.analysis.detection_metrics import evaluate_detections as jax_evaluate
from hcunet_tpu.models.resnet import ResNet as JaxResNet
from hcunet_tpu.train import pretrain as jax_pretrain
from hcunet_tpu_torch.analysis.detection_metrics import evaluate_detections
from hcunet_tpu_torch.train import pretrain
from hcunet_tpu_torch.train.parity import flat
from tests.test_torch_port_detection_train import detector_pair
from tests.torch_port_support import assert_trajectories_match

WIDTH, HW, BATCH, STEPS, LR = 8, (48, 48), 4, 3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the CPU's float32 sums depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_shapes_batch_equals_jax(seed):
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in (2, 5):
        (ij, lj), (it, lt) = (jax_pretrain.synthetic_shapes_batch(rng_j, n, HW),
                              pretrain.synthetic_shapes_batch(rng_t, n, HW))
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(lt, lj)
        assert it.dtype == ij.dtype and lt.dtype == lj.dtype


def _jax_classifier_init(seed=0):
    """The JAX ``pretrain_backbone``'s classifier and its initial variables
    (the same module tree, the same key, as that function builds them)."""

    class Classifier(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool):
            feats = JaxResNet(width=WIDTH, name="body")(x, train)
            return fnn.Dense(pretrain.N_CLASSES, name="probe")(feats["c5"].mean(axis=(1, 2)))

    x0, _ = jax_pretrain.synthetic_shapes_batch(np.random.default_rng(seed), 2, HW)
    variables = Classifier().init(jax.random.PRNGKey(seed), jnp.asarray(x0), train=False)
    return jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def trained():
    init = _jax_classifier_init()
    logs = []
    want = jax_pretrain.pretrain_backbone(steps=STEPS, batch=BATCH, lr=LR, width=WIDTH, hw=HW,
                                          log_every=0)
    got = pretrain.pretrain_backbone(steps=STEPS, batch=BATCH, lr=LR, width=WIDTH, hw=HW,
                                     log_every=1, progress=logs.append, device="cpu",
                                     init_variables=init)
    return init, jax.tree.map(np.asarray, want), got, logs


def test_pretrain_backbone_matches_jax(trained):
    init, want, got, logs = trained
    start = {"params": init["params"]["body"], "batch_stats": init["batch_stats"]["body"]}
    assert_trajectories_match(got, want, start, LR, STEPS)
    assert len(logs) == STEPS and logs[-1].startswith(f"pretrain step {STEPS}/{STEPS}: loss ")


def test_pretrain_backbone_seeded_init_trains(monkeypatch):
    """Without ``init_variables`` the weights come from the seed (flax's
    LeCun-normal, the zero last BN); the device is CUDA unless given."""
    out = pretrain.pretrain_backbone(steps=1, batch=2, width=WIDTH, hw=HW, log_every=0,
                                     device="cpu")
    assert set(out) == {"params", "batch_stats"}
    assert "stage5_block2" in out["params"]
    assert float(np.abs(out["params"]["stage2_block0"]["BatchNorm_2"]["scale"]).max()) < 0.01
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.pretrain_backbone(steps=1, batch=2, width=WIDTH, hw=HW)


def test_save_load_backbone_flax_bytes(trained, tmp_path):
    _init, want, got, _logs = trained
    path = tmp_path / "port.msgpack"
    pretrain.save_backbone(str(path), got)
    assert path.read_bytes() == serialization.to_bytes(got)
    jax_path = tmp_path / "jax.msgpack"
    jax_pretrain.save_backbone(str(jax_path), want)
    back = pretrain.load_backbone(str(jax_path), template=want)
    a, b = flat(back), flat(want)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)
    jax_back = jax_pretrain.load_backbone(str(path), template=want)
    assert all(np.array_equal(np.asarray(v), flat(got)[k]) for k, v in flat(jax_back).items())
    with pytest.raises(ValueError):
        pretrain.load_backbone(str(path), template={"params": {}, "batch_stats": {}})


def test_seed_detector_backbone_matches_jax():
    """Seeding the small-backbone detector's trunk body with a tree of the
    same shapes gives JAX's tree; a mismatched shape raises ``ValueError``
    on both sides."""
    _jd, variables, _t = detector_pair()
    body = {"params": jax.tree.map(lambda a: a + 1.0, variables["trunk"]["params"]["body"]),
            "batch_stats": jax.tree.map(lambda a: a * 2.0, variables["trunk"]["batch_stats"]["body"])}
    got = flat(pretrain.seed_detector_backbone(variables, body))
    want = flat(jax.tree.map(np.asarray, jax_pretrain.seed_detector_backbone(variables, body)))
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert np.array_equal(flat(variables)[("trunk", "params", "body", "Conv_0", "kernel")] + 1.0,
                          got[("trunk", "params", "body", "Conv_0", "kernel")])
    bad = jax.tree.map(np.copy, body)
    bad["params"]["Conv_0"]["kernel"] = np.zeros((1, 1, 3, 8), np.float32)
    for fn in (pretrain.seed_detector_backbone, jax_pretrain.seed_detector_backbone):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(variables, bad)


def _img(boxes, labels, scores=None):
    d = {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
         "labels": np.asarray(labels, np.int32)}
    if scores is not None:
        d["scores"] = np.asarray(scores, np.float32)
    return d


# tests/test_detection_metrics.py:19-60: (predictions, ground truths, what to check)
METRIC_CASES = {
    "perfect": ([_img([[0, 0, 10, 10], [20, 20, 30, 30]], [1, 2], [0.9, 0.8])],
                [_img([[0, 0, 10, 10], [20, 20, 30, 30]], [1, 2])],
                {"map": 1.0, "recall": 1.0}),
    "hand_computed": ([_img([[0, 0, 10, 10], [100, 100, 110, 110], [50, 50, 60, 60]],
                            [1, 1, 1], [0.9, 0.8, 0.7])],
                      [_img([[0, 0, 10, 10], [50, 50, 60, 60]], [1, 1])],
                      {"ap1": 0.5 + 0.5 * 2 / 3, "recall1": 1.0}),
    "duplicate_is_fp": ([_img([[0, 0, 10, 10], [1, 1, 11, 11]], [1, 1], [0.9, 0.8])],
                        [_img([[0, 0, 10, 10]], [1])],
                        {"ap1": 1.0, "recall": 1.0}),
    "wrong_class": ([_img([[0, 0, 10, 10]], [1], [0.9])], [_img([[0, 0, 10, 10]], [2])],
                    {"map": 0.0, "recall": 0.0}),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_evaluate_detections_cases(case):
    pred, gts, expect = METRIC_CASES[case]
    res = evaluate_detections(pred, gts)
    assert res == jax_evaluate(pred, gts)
    for key, value in expect.items():
        got = {"map": res["map"], "recall": res["recall"]}.get(key)
        if key.endswith("1"):
            got = res["per_class"][1]["ap" if key == "ap1" else "recall"]
        assert got == pytest.approx(value), key


def test_evaluate_detections_matches_jax_on_seeded_detections():
    """5 images of 3 classes: ground truth, and noisy, duplicated, missed
    and spurious detections with random scores; the two results equal."""
    rng = np.random.default_rng(5)
    preds, gts = [], []
    for _ in range(5):
        n = int(rng.integers(1, 8))
        xy = rng.uniform(0, 200, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (n, 2))], 1)
        labels = rng.integers(1, 4, n)
        keep = rng.random(n) > 0.2
        p_boxes = boxes[keep] + rng.normal(0, 2, (int(keep.sum()), 4))
        p_labels = np.where(rng.random(int(keep.sum())) > 0.1, labels[keep], 1)
        extra = rng.uniform(0, 220, (2, 2))
        p_boxes = np.concatenate([p_boxes, p_boxes[:1], np.concatenate([extra, extra + 12], 1)])
        p_labels = np.concatenate([p_labels, p_labels[:1], rng.integers(1, 4, 2)])
        gts.append(_img(boxes, labels))
        preds.append(_img(p_boxes, p_labels, rng.random(len(p_labels))))
    for thresh in (0.5, 0.75):
        res = evaluate_detections(preds, gts, iou_thresh=thresh)
        assert res == jax_evaluate(preds, gts, iou_thresh=thresh)
    assert 0 < res["map"] < 1
