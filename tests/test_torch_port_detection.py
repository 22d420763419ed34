"""The port's detector (``hcunet_tpu_torch/models/detection.py`` and its
ops and the tiled detection) against the JAX package's, on the same weights.

The JAX ``Detector``'s variable tree gets random values for every weight
and every batch-norm scale, bias and statistic from a seeded numpy
generator (the JAX init's zero last-BN scale would hide a wrong residual
branch), and :func:`detector_state_dict_from_jax_variables` carries it into
the port.  The kernels are LeCun-normal, and the RPN head and box predictor
small as in torchvision's init, so that the box deltas stay O(0.1) and the
detections are real boxes.  Tolerances, all float32 on the CPU:

* trunk features within 2e-4 x max(1, max|ref|) (XLA's and PyTorch's
  convolutions sum in different orders through ~50 layers);
* RoIAlign within 1e-5, NMS keep sets equal;
* ``detect``: the valid rows equal in count and labels, boxes within
  1e-3 px, scores within 1e-5.  Invalid rows (``-inf`` scores) may hold
  other boxes and are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.infer.detect import predict_cell_candidates as jax_predict_cell_candidates
from hcunet_tpu.models.detection import LEVELS
from hcunet_tpu.models.detection import Detector as JaxDetector
from hcunet_tpu.ops.nms import nms_mask as jax_nms_mask
from hcunet_tpu.ops.roi_align import roi_align as jax_roi_align
from hcunet_tpu.utils.port_torchvision import detector_variables_from_torchvision
from hcunet_tpu_torch.config import DetectorConfig
from hcunet_tpu_torch.infer.detect import predict_cell_candidates
from hcunet_tpu_torch.models.detection import Detector
from hcunet_tpu_torch.ops.nms import nms_indices, nms_mask
from hcunet_tpu_torch.ops.roi_align import roi_align
from hcunet_tpu_torch.utils.port_jax import detector_state_dict_from_jax_variables

CFG = dict(
    num_classes=3,
    max_detections=25,
    rpn_pre_nms_top_n=200,
    rpn_post_nms_top_n=64,
    anchor_sizes=(16, 32, 64, 128, 256),
)
HW = {"resnet50": (96, 80), "small": (112, 128)}


def randomize(tree, rng, path=()):
    """Random values for every leaf of a JAX detector variable tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng, path + (k,))
            continue
        if k == "kernel":
            std = np.sqrt(1.0 / np.prod(v.shape[:-1]))
            if "rpn_head" in path:
                std = 0.01
            elif path[-1] in ("cls_score", "bbox_pred"):
                std = 0.1 if path[-1] == "cls_score" else 0.001
            v = rng.standard_normal(v.shape) * std
        elif k in ("scale", "var"):
            v = rng.random(v.shape) + 0.5
        else:  # biases and means
            v = rng.standard_normal(v.shape) * 0.1
        out[k] = np.asarray(v, np.float32)
    return out


def _detectors(backbone, width=8, seed=0):
    """(JAX detector, its numpy variables, the port's detector)."""
    jdet = JaxDetector(JaxDetectorConfig(**CFG), backbone=backbone, backbone_width=width)
    shapes = jax.eval_shape(lambda k: jdet.init(k, HW[backbone]), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = {
        part: {kind: randomize(tree, rng) for kind, tree in shapes[part].items()}
        for part in ("trunk", "head")
    }
    tdet = Detector(DetectorConfig(**CFG), backbone=backbone, backbone_width=width,
                    device="cpu")
    tdet.load_state_dict(detector_state_dict_from_jax_variables(variables, backbone))
    return jdet, variables, tdet


@pytest.fixture(scope="module", params=["resnet50", "small"])
def pair(request):
    return request.param, _detectors(request.param)


def _images(backbone, n=2, seed=1):
    return np.random.default_rng(seed).random((n, *HW[backbone], 3), np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())), rtol=0)


def test_trunk_features_match_jax(pair):
    backbone, (jdet, variables, tdet) = pair
    img = _images(backbone, n=1)
    jpyr, jrpn = jdet.trunk.apply(variables["trunk"], jnp.asarray(img), train=False)
    with torch.no_grad():
        pyr, rpn = tdet(torch.from_numpy(img).permute(0, 3, 1, 2))
    for lvl in LEVELS:
        _close(pyr[lvl].permute(0, 2, 3, 1), jpyr[lvl], 2e-4)
        for i in range(2):
            _close(rpn[lvl][i].permute(0, 2, 3, 1), jrpn[lvl][i], 2e-4)


def test_detect_matches_jax(pair):
    backbone, (jdet, variables, tdet) = pair
    imgs = _images(backbone)
    want = {k: np.asarray(v) for k, v in jdet.detect(variables, jnp.asarray(imgs)).items()}
    got = {k: v.numpy() for k, v in tdet.detect(imgs).items()}
    assert got["boxes"].shape == want["boxes"].shape == (2, CFG["max_detections"], 4)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], atol=1e-5, rtol=0)


def test_predict_cell_candidates_matches_jax(pair):
    """Two tile positions per axis over a small 3-plane volume: tiling, the
    axis swap and the host NMS merge."""
    backbone, (jdet, variables, tdet) = pair
    vol = np.random.default_rng(2).random((150, 140, 3, 3), np.float32)
    kw = dict(eval_size=(100, 90), pad=(8, 8))
    want = jax_predict_cell_candidates(vol, jdet, variables, **kw)
    got = predict_cell_candidates(vol, tdet, device="cpu", **kw)
    assert set(got) == set(want) == {"boxes", "scores", "labels", "z_level"}
    assert len(want["scores"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["z_level"], want["z_level"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)


def test_port_state_dict_reads_back_through_port_torchvision():
    """``port_torchvision.detector_variables_from_torchvision`` reads the
    port's (torchvision-named) state dict back into the same JAX tree."""
    jdet, variables, tdet = _detectors("resnet50", width=8, seed=3)
    back = detector_variables_from_torchvision(tdet.state_dict())
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def _random_boxes(rng, shape):
    xy = rng.uniform(0, 60, (*shape, 2))
    wh = rng.uniform(2, 30, (*shape, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[..., 5, :] = boxes[..., 4, :]  # an exact duplicate
    return boxes


@pytest.mark.parametrize("thr", [0.2, 0.5, 0.7])
def test_nms_mask_equals_jax(thr):
    rng = np.random.default_rng(4)
    boxes = _random_boxes(rng, (3, 120))
    scores = rng.random((3, 120)).astype(np.float32)
    scores[:, 7] = scores[:, 8]  # a tie, broken by index
    scores[:, 10:14] = -np.inf
    valid = rng.random((3, 120)) > 0.1
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                   valid=torch.from_numpy(valid)).numpy()
    for b in range(3):  # the JAX function is per image; the port's batched
        want = np.asarray(jax_nms_mask(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr, valid=jnp.asarray(valid[b])
        ))
        np.testing.assert_array_equal(got[b], want)
        kept = np.flatnonzero(got[b])
        host = nms_indices(boxes[b], scores[b], thr, valid=valid[b])
        np.testing.assert_array_equal(np.sort(host), kept)
    assert not got[:, 10:14].any()


def test_roi_align_equals_jax():
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 24, 20, 5)).astype(np.float32)
    boxes = np.asarray(
        [[2.5, 3.25, 15.0, 20.0], [-4.0, -2.0, 6.0, 7.5], [12.0, 18.0, 30.0, 30.0],
         [5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 19.0, 23.0]],
        np.float32,
    )
    img = np.asarray([0, 1, 1, 0, 1])
    for scale, osize, sratio in [(1.0, 7, 2), (0.5, 5, 2), (0.25, 3, 4)]:
        got = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), scale, osize,
                        sratio, batch_index=torch.from_numpy(img)).numpy()
        for i, b in enumerate(img):
            want = np.asarray(jax_roi_align(
                jnp.asarray(feat[b]), jnp.asarray(boxes[i:i + 1]), scale,
                output_size=osize, sampling_ratio=sratio,
            ))
            np.testing.assert_allclose(got[i:i + 1], want, atol=1e-5, rtol=0)


def test_anchors_and_box_coding_equal_jax():
    from hcunet_tpu.models import detection as jd
    from hcunet_tpu_torch.models import detection as td

    shapes = {"p2": (24, 20), "p3": (12, 10), "p4": (6, 5), "p5": (3, 3), "p6": (2, 2)}
    want = jd.generate_anchors(shapes, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    got = td.generate_anchors(shapes, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    for lvl in shapes:
        np.testing.assert_array_equal(got[lvl].numpy(), np.asarray(want[lvl]))

    rng = np.random.default_rng(6)
    ref = rng.uniform(0, 50, (40, 2))
    ref = np.concatenate([ref, ref + rng.uniform(1, 30, (40, 2))], 1).astype(np.float32)
    gt = (ref + rng.normal(0, 3, ref.shape)).astype(np.float32)
    deltas = rng.normal(0, 2, (40, 4)).astype(np.float32)  # some clamp at log(1000/16)
    w = td.Detector.BOX_WEIGHTS
    np.testing.assert_allclose(
        td.encode_boxes(torch.from_numpy(ref), torch.from_numpy(gt), w).numpy(),
        np.asarray(jd.encode_boxes(jnp.asarray(ref), jnp.asarray(gt), w)), atol=1e-5, rtol=1e-6,
    )
    dec = td.decode_boxes(torch.from_numpy(ref), torch.from_numpy(deltas), w)
    jdec = jd.decode_boxes(jnp.asarray(ref), jnp.asarray(deltas), w)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-3, rtol=1e-6)
    np.testing.assert_array_equal(
        td.clip_boxes(dec, (40, 45)).numpy(),
        np.asarray(jd.clip_boxes(jnp.asarray(dec.numpy()), (40, 45))),
    )
