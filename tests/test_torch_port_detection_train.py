"""Detection training in the PyTorch port against the JAX package, on the
CPU, on the same weights and numpy inputs: ``Detector.losses`` (the four
terms, the trunk's new running statistics and every gradient), the forced
positive that a padded ground-truth slot shares, the trunks' train-mode
batch norm against flax's (momentum 0.99, biased variance), and the
trainer's input checks.

The detector is the small backbone at width 8 on a 64 x 64 image with 3
real boxes and 3 padded slots, random weights from a seed as in
``test_torch_port_detection.py``.  Tolerances, float32 on both sides: each
loss term within 1e-5 relative, the running statistics within 1e-6, each
gradient within 1e-4 of its tensor's scale (a conv bias that a batch norm
cancels has a gradient of 0 up to rounding on both sides, held to 1e-4 of
its kernel's gradient instead).

``detector_pair``, ``gt`` and ``IMAGE_HW`` serve
``test_torch_port_detection_trainer.py`` too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.models.detection import Detector as JaxDetector
from hcunet_tpu.models.resnet import ResNet as JaxResNet
from hcunet_tpu_torch.config import DetectorConfig
from hcunet_tpu_torch.models.detection import Detector, generate_anchors
from hcunet_tpu_torch.models.resnet import ResNet
from hcunet_tpu_torch.ops.nms import box_iou
from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer
from hcunet_tpu_torch.train.parity import bn_cancelled, flat
from hcunet_tpu_torch.utils.port_jax import (
    backbone_state_dict_from_jax,
    detector_state_dict_from_jax_variables,
    jax_backbone_from_state_dict,
    jax_variables_from_detector_state_dict,
)
from tests.test_torch_port_detection import randomize

IMAGE_HW = (64, 64)
CFG = dict(num_classes=3, max_detections=8, rpn_pre_nms_top_n=32, rpn_post_nms_top_n=16,
           anchor_sizes=(16, 32, 64, 128, 256))
MAX_GT = 6
BOXES = np.asarray([[4, 4, 20, 22], [30, 10, 50, 30], [10, 40, 28, 60]], np.float32)
LABELS = np.asarray([1, 2, 1], np.int32)


def detector_pair(seed=0):
    """``(JAX detector, its numpy variables, the port's detector)``: the
    small backbone at width 8 with random weights from ``seed``."""
    jdet = JaxDetector(JaxDetectorConfig(**CFG), backbone="small", backbone_width=8)
    shapes = jax.eval_shape(lambda k: jdet.init(k, IMAGE_HW), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = {part: {kind: randomize(tree, rng) for kind, tree in shapes[part].items()}
                 for part in ("trunk", "head")}
    tdet = Detector(DetectorConfig(**CFG), backbone="small", backbone_width=8, device="cpu")
    tdet.load_state_dict(detector_state_dict_from_jax_variables(variables, "small"))
    return jdet, variables, tdet


def gt(boxes=BOXES, labels=LABELS, max_gt=MAX_GT):
    """Ground truth padded to ``max_gt``: ``(boxes, labels, valid)``."""
    n = len(labels)
    pb = np.zeros((max_gt, 4), np.float32)
    pl = np.zeros((max_gt,), np.int32)
    pv = np.zeros((max_gt,), bool)
    pb[:n], pl[:n], pv[:n] = boxes, labels, True
    return pb, pl, pv


def image(seed=1):
    return np.random.default_rng(seed).random((1, *IMAGE_HW, 3), np.float32)


@functools.lru_cache(maxsize=None)
def _jax_losses_fn():
    jdet, _v, _t = _pair()

    def fn(params, stats, img, boxes, labels, valid):
        v = {"trunk": {"params": params["trunk"], "batch_stats": stats},
             "head": {"params": params["head"]}}
        losses, upd = jdet.losses(v, img, boxes, labels, valid, train=True)
        return sum(losses.values()), (losses, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def _pair():
    return detector_pair()


def jax_losses(img, boxes, labels, valid):
    """The JAX ``losses`` terms, the new trunk statistics and the gradient
    of their sum, as numpy."""
    _jd, variables, _t = _pair()
    params = {"trunk": variables["trunk"]["params"], "head": variables["head"]["params"]}
    (_tot, (losses, stats)), grads = _jax_losses_fn()(
        params, variables["trunk"]["batch_stats"], *(jnp.asarray(a) for a in (img, boxes, labels, valid)))
    return ({k: float(v) for k, v in losses.items()}, jax.tree.map(np.asarray, stats),
            jax.tree.map(np.asarray, grads))


def port_losses(img, boxes, labels, valid):
    """The port's terms, the new trunk statistics (the JAX tree) and the
    gradients (the JAX tree), on a fresh port detector."""
    _jd, variables, _t = _pair()
    tdet = Detector(DetectorConfig(**CFG), backbone="small", backbone_width=8, device="cpu")
    tdet.load_state_dict(detector_state_dict_from_jax_variables(variables, "small"))
    before = {k: v.clone() for k, v in tdet.state_dict().items()}
    losses, stats = tdet.losses(*(torch.from_numpy(a) for a in (img, boxes, labels, valid)))
    sum(losses.values()).backward()
    for k, v in tdet.state_dict().items():  # the buffers come back as they were
        assert torch.equal(v, before[k]), k
    assert not tdet.training
    sd = dict(tdet.state_dict(), **stats)
    new_stats = jax_variables_from_detector_state_dict(sd, "small")["trunk"]["batch_stats"]
    grads = jax_variables_from_detector_state_dict(
        dict(sd, **{n: p.grad for n, p in tdet.named_parameters()}), "small")
    grads = {"trunk": grads["trunk"]["params"], "head": grads["head"]["params"]}
    return {k: float(v.detach()) for k, v in losses.items()}, new_stats, grads


def assert_detector_grads_match(got, want, rtol=1e-4):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if bn_cancelled(path):
            scale = float(np.abs(want[path[:-1] + ("kernel",)]).max())
            assert max(float(np.abs(w).max()), float(np.abs(got[path]).max())) <= 1e-4 * scale, path
        np.testing.assert_allclose(got[path], w, rtol=0, atol=rtol * scale, err_msg=str(path))


def _check_against_jax(img, boxes, labels, valid):
    want_l, want_s, want_g = jax_losses(img, boxes, labels, valid)
    got_l, got_s, got_g = port_losses(img, boxes, labels, valid)
    assert got_l.keys() == want_l.keys()
    for k, w in want_l.items():
        assert abs(got_l[k] - w) <= 1e-5 * abs(w), (k, got_l[k], w)
    gs, ws = flat(got_s), flat(want_s)
    assert gs.keys() == ws.keys()
    for path, w in ws.items():
        np.testing.assert_allclose(gs[path], w, rtol=1e-6, atol=1e-6, err_msg=str(path))
    assert_detector_grads_match(got_g, want_g)
    return got_l


def test_detector_losses_match_jax():
    """``Detector.losses`` on 3 boxes and 3 padded slots: every term
    non-zero, as in JAX."""
    losses = _check_against_jax(image(), *gt())
    assert all(v > 0 for v in losses.values()), losses


def test_padded_slot_shares_the_forced_positive():
    """A real box whose best anchor is anchor 0 (the index every padded
    slot's argmax lands on) at an IoU below 0.7: only the forced positive
    makes it positive, and the padded slots must not clear it."""
    boxes = np.concatenate([BOXES[:2], [[0, 0, 8, 4]]]).astype(np.float32)
    pb, pl, pv = gt(boxes)
    tdet = _pair()[2]
    with torch.no_grad():
        pyramid, _rpn = tdet(torch.from_numpy(image()).permute(0, 3, 1, 2))
    shapes = {lvl: tuple(p.shape[-2:]) for lvl, p in pyramid.items()}
    anchors = torch.cat(list(generate_anchors(shapes, CFG["anchor_sizes"], (0.5, 1.0, 2.0)).values()))
    iou = box_iou(anchors, torch.from_numpy(boxes))
    assert int(iou[:, 2].argmax()) == 0 and float(iou[:, 2].max()) < 0.7
    _check_against_jax(image(), pb, pl, pv)


def test_resnet_train_mode_bn_matches_flax():
    """The trunks' batch norm in training mode against flax's default
    ``nn.BatchNorm`` (momentum 0.99, the biased variance; torch's
    ``BatchNorm2d`` rule, momentum 0.1 and the unbiased variance, is
    another): one layer within 1e-5 of the output's scale and the running
    statistics within 1e-6; then the whole ResNet trunk (width 8, 2 x 64 x
    64): every feature level within 1e-3 of its scale and every running
    statistic within 2e-5 of max(1, its scale) (batch statistics over few
    elements at c4 and c5, 2 x 2 x 2 at c5, amplify the two sides' float32
    rounding through ~50 layers: measured 6.2e-4 at c5 and 8.8e-6)."""
    import flax.linen as fnn

    from hcunet_tpu_torch.models.resnet import BatchNorm

    x = np.random.default_rng(4).standard_normal((3, 5, 6, 8)).astype(np.float32) * 2 + 0.5
    bn_vars = {"params": {"scale": np.linspace(0.5, 1.5, 8, dtype=np.float32),
                          "bias": np.linspace(-0.2, 0.3, 8, dtype=np.float32)},
               "batch_stats": {"mean": np.full(8, 0.1, np.float32),
                               "var": np.full(8, 1.2, np.float32)}}
    want, upd = fnn.BatchNorm(use_running_average=False).apply(
        bn_vars, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(8).train()
    bn.load_state_dict({"weight": torch.from_numpy(bn_vars["params"]["scale"]),
                        "bias": torch.from_numpy(bn_vars["params"]["bias"]),
                        "running_mean": torch.full((8,), 0.1),
                        "running_var": torch.full((8,), 1.2),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * np.abs(want).max())
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=1e-6, err_msg=name)

    jnet = JaxResNet(width=8)
    x = np.random.default_rng(3).random((2, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x), x)
    rng = np.random.default_rng(0)
    variables = {k: randomize(v, rng) for k, v in shapes.items()}
    feats, upd = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    net = ResNet(width=8)
    net.load_state_dict({k[len("b."):]: v for k, v in backbone_state_dict_from_jax(
        variables, prefix="b").items()})
    got = net.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for lvl, want in feats.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[lvl].detach().permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-3 * max(1.0, np.abs(want).max()), err_msg=lvl)
    stats = flat(jax_backbone_from_state_dict(
        {f"b.{k}": v for k, v in net.state_dict().items()}, prefix="b")["batch_stats"])
    want_stats = flat(jax.tree.map(np.asarray, upd["batch_stats"]))
    assert stats.keys() == want_stats.keys()
    for path, w in want_stats.items():
        np.testing.assert_allclose(stats[path], w, rtol=0, atol=2e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))
    # the zero-init last BN, as the JAX block's
    fresh = ResNet(width=8)
    assert all(float(b.bn3.weight.abs().max()) == 0 for layer in (fresh.layer1, fresh.layer4)
               for b in layer)


def test_trainer_checks_raise_where_jax_raises():
    """``_pad_gt`` above ``max_gt``, ``_guard_finite`` on nan and inf, and
    ``_iter_batches`` on mixed image sizes; it wraps to fill the last
    group."""
    tr = DetectionTrainer(_pair()[2], cfg=DetectionTrainConfig(max_gt=2), batch_size=2,
                          device="cpu")
    with pytest.raises(ValueError, match="max_gt=2"):
        tr._pad_gt(BOXES, LABELS)
    pb, pl, pv = tr._pad_gt(BOXES[:1], LABELS[:1])
    assert pb.shape == (2, 4) and pv.tolist() == [True, False] and pl.tolist() == [1, 0]
    for bad, word in ((np.nan, "nan"), (np.inf, "inf")):
        img = image()
        img[0, 3, 3, 1] = bad
        with pytest.raises(ValueError, match=word):
            tr.train_step(img, BOXES[:1], LABELS[:1])
    target = {"boxes": BOXES[:1], "labels": LABELS[:1]}
    ds = [(image(s), target) for s in range(3)]
    groups = list(tr._iter_batches(ds))
    assert len(groups) == 2 and groups[1][0].shape == (2, *IMAGE_HW, 3)
    np.testing.assert_array_equal(groups[1][0][1], ds[0][0][0])  # wrapped
    mixed = [(image(), target), (np.zeros((1, 32, 32, 3), np.float32), target)]
    with pytest.raises(ValueError, match="mixed sizes"):
        list(tr._iter_batches(mixed))
    with pytest.raises(ValueError, match="total_steps"):
        DetectionTrainer(_pair()[2], cfg=DetectionTrainConfig(schedule="cosine"), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        DetectionTrainer(_pair()[2], mesh=object(), device="cpu")
