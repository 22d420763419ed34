"""Plain reference of ``frcnn-r50fpn-hcat``: the reference pipeline's cell
detector, torchvision's ``fasterrcnn_resnet50_fpn(num_classes=3,
box_detections_per_img=500)`` (wisamreid/HcUnet ``hcat/rcnn.py:7-21``) in
eval mode, run over a chunk's z-planes in 1047-wide windows and merged
across planes and windows at IoU 0.2 (``hcat/segment.py:139-218``,
``hcat/utils.py:77-124`` and ``:336-366``), in plain PyTorch, float32 with
TF32 off.

Written from the published descriptions: ResNet-50 (He et al.,
arXiv:1512.03385; the stride on the 3x3 conv of a bottleneck, as
torchvision's), the feature pyramid (Lin et al., arXiv:1612.03144: 1x1
laterals, nearest top-down upsampling, 3x3 outputs, p6 a stride-2 pool of
p5), Faster R-CNN (Ren et al., arXiv:1506.01497: a shared 3x3 conv and 1x1
objectness and box layers over every level, per-level top-k, decode, clip
and NMS, RoIAlign of each proposal from the level its size maps to, a
two-layer MLP head, per-class decode, score threshold, NMS and top-k).
Batch norm is frozen: ``(x - mean) / sqrt(var + 1e-5) * weight + bias``.

Departures from torchvision that the system makes, and this reference
with it:

1. no ``GeneralizedRCNNTransform``: no resize to 800/1333, no ImageNet
   mean and deviation, no padding to a multiple of 32; a window is detected
   at its own size, in the values ``analyze``'s normalisation gives;
2. anchor strides 4, 8, 16, 32, 64 whatever the image size (torchvision
   divides the padded image's size by the feature map's), base anchors
   ``(+-w/2, +-h/2)``, ``w = size / sqrt(ratio)``, ``h = size * sqrt(ratio)``,
   not rounded to whole pixels;
3. the top-down upsampling takes source index ``floor((i + 1/2) * n_in /
   n_out)`` (torch's ``nearest-exact``; torchvision's ``nearest`` takes
   ``floor(i * n_in / n_out)``: they differ where the sizes are not a
   power-of-two ratio, as 66 to 131);
4. RPN NMS runs within each level, the levels one after another
   (torchvision's ``batched_nms`` offsets each level's boxes apart in one
   call: the same keep sets); the post-NMS top 1000 is taken over all
   levels by logit;
5. a box is assigned the level ``floor(4 + log2(sqrt(area) / 224))``, area
   at least 1e-6 (torchvision adds 1e-6 inside the floor);
6. the box stage's per-class NMS runs as one NMS over boxes offset by
   ``label * (max(H, W) + 2)`` (torchvision offsets by ``label *
   (max coordinate + 1)``); its candidates are class-major (torchvision's
   are proposal-major: only ties in score are ordered otherwise); rows past
   the valid proposals are dropped.

Parameter names are torchvision's state-dict names, so the same tensors
load into the program's ``Detector`` and feed this one.  The weights the
benchmark draws (:func:`param_specs`) are completed by
:func:`detector_weights`, which centres the class logits' weights and
calibrates the background's logit bias on windows of the cell's chunks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

EPS = 1e-5
LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDE = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# torchvision's bbox_xform_clip
DELTA_CLIP = math.log(1000.0 / 16)
CLS = "roi_heads.box_predictor.cls_score"


# --- weights -------------------------------------------------------------------


def _body_layout(cfg: dict):
    """``(prefix, cin, width, stride, projected)`` of each bottleneck."""
    blocks, cin = [], cfg["width"]
    for stage, n in enumerate(cfg["stage_sizes"]):
        width = cfg["width"] * 2 ** stage
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out = width * cfg["bottleneck_expansion"]
            blocks.append((f"backbone.body.layer{stage + 1}.{b}", cin, width, stride,
                           cin != out or stride != 1))
            cin = out
    return blocks


def _stage_channels(cfg: dict) -> List[int]:
    return [cfg["width"] * 2 ** s * cfg["bottleneck_expansion"]
            for s in range(len(cfg["stage_sizes"]))]


def param_specs(cfg: dict):
    """``(name, shape, kind, scale)`` of every parameter and batch-norm
    statistic.  Body convs He-normal, batch norms near the identity except
    each bottleneck's last, whose scale is a normal of deviation 0.2 (so
    that 16 residual adds keep the activations' scale); FPN convs
    LeCun-normal (no ReLU follows them); the RPN's shared conv He-normal
    and its two outputs of deviation 0.01 (torchvision's init); the head's
    MLP He-normal, its class logits of deviation 0.05 and its box deltas of
    0.001 (torchvision's); biases normal of deviation 0.05."""
    specs = []

    def conv(name, cin, cout, k, gain, bias=True, std=None):
        std = math.sqrt(gain / (cin * k * k)) if std is None else std
        specs.append((f"{name}.weight", (cout, cin, k, k), "normal", std))
        if bias:
            specs.append((f"{name}.bias", (cout,), "normal", 0.05))

    def bn(name, c, small=False):
        specs.extend([
            (f"{name}.weight", (c,), "normal" if small else "uniform", 0.2),
            (f"{name}.bias", (c,), "normal", 0.05),
            (f"{name}.running_mean", (c,), "normal", 0.05),
            (f"{name}.running_var", (c,), "uniform", 0.25),
        ])

    w0, x4 = cfg["width"], cfg["bottleneck_expansion"]
    conv("backbone.body.conv1", 3, w0, 7, 2, bias=False)
    bn("backbone.body.bn1", w0)
    for prefix, cin, width, _stride, projected in _body_layout(cfg):
        conv(f"{prefix}.conv1", cin, width, 1, 2, bias=False)
        bn(f"{prefix}.bn1", width)
        conv(f"{prefix}.conv2", width, width, 3, 2, bias=False)
        bn(f"{prefix}.bn2", width)
        conv(f"{prefix}.conv3", width, width * x4, 1, 2, bias=False)
        bn(f"{prefix}.bn3", width * x4, small=True)
        if projected:
            conv(f"{prefix}.downsample.0", cin, width * x4, 1, 2, bias=False)
            bn(f"{prefix}.downsample.1", width * x4)
    c = cfg["fpn_channels"]
    for i, cin in enumerate(_stage_channels(cfg)):
        conv(f"backbone.fpn.inner_blocks.{i}.0", cin, c, 1, 1)
        conv(f"backbone.fpn.layer_blocks.{i}.0", c, c, 3, 1)
    a = len(cfg["anchor_ratios"])
    conv("rpn.head.conv.0.0", c, c, 3, 2)
    conv("rpn.head.cls_logits", c, a, 1, 0, std=0.01)
    conv("rpn.head.bbox_pred", c, 4 * a, 1, 0, std=0.01)
    k, rep, n_cls = cfg["roi_align_output"], cfg["representation_size"], cfg["num_classes"]

    def linear(name, cin, cout, std):
        specs.append((f"{name}.weight", (cout, cin), "normal", std))
        specs.append((f"{name}.bias", (cout,), "normal", 0.05))

    linear("roi_heads.box_head.fc6", c * k * k, rep, math.sqrt(2 / (c * k * k)))
    linear("roi_heads.box_head.fc7", rep, rep, math.sqrt(2 / rep))
    linear(CLS, rep, n_cls, 0.05)
    linear("roi_heads.box_predictor.bbox_pred", rep, 4 * n_cls, 0.001)
    return specs


def centred(W: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The drawn weights ``W`` with each row of the class logits' weights
    less its mean: fc7's outputs, after a ReLU, share a positive mean that
    would otherwise put a large seed-dependent offset between the classes (a
    new dict; ``W`` is left as it is)."""
    out = dict(W)
    weight = W[f"{CLS}.weight"]
    out[f"{CLS}.weight"] = weight - weight.mean(1, keepdim=True)
    return out


def with_background_bias(W: Dict[str, torch.Tensor], bias: float) -> Dict[str, torch.Tensor]:
    out = dict(W)
    b = W[f"{CLS}.bias"].clone()
    b[0] += bias
    out[f"{CLS}.bias"] = b
    return out


def detector_weights(W: Dict[str, torch.Tensor], cfg: dict, windows: List[torch.Tensor],
                     P: Precision, shares: Sequence[float] = (),
                     steps: int = 16) -> Dict[str, torch.Tensor]:
    """The detector's weights from the drawn ``W``: :func:`centred`, then the
    background's logit bias raised by the amount at which this reference
    keeps ``merged_target`` candidates a window, on average over
    ``windows`` (each the planes [B, H, W, 3] of one window, its
    detections merged by :func:`merge`; window ``i`` weighted by
    ``shares[i]``, 1 where not given), or the nearest average that a
    bisection over [-20, 40] tries, stopping within 1 % of the target.  The class logits of the network's random features sit a
    seed-dependent distance apart and spread little from proposal to
    proposal, and how far a plane's boxes recur in the next plane depends
    on the seed too: no one bias, and no count a plane, holds the merged
    list, and with it the host merge's work, near one size over seeds; and
    with boxes that do not recur the list grows with the planes, so the
    windows should stand for every depth the merge will see."""
    W = centred(W)
    shares = [float(s) for s in shares] or [1.0] * len(windows)
    total = sum(shares)
    outputs = []
    for planes in windows:
        hw = tuple(planes.shape[1:3])
        pyramid, rpn = trunk(W, cfg, planes, P)
        props, valid = proposals(cfg, rpn, hw)
        B, n = props.shape[:2]
        img = torch.arange(B, device=props.device).repeat_interleave(n)
        logits, deltas = head(W, cfg, pyramid, props.reshape(-1, 4), img, P)
        outputs.append((props, valid, logits.reshape(B, n, -1), deltas.reshape(B, n, -1), hw))
        del pyramid, rpn
    target = cfg["merged_target"]
    lo, hi, tried = -20.0, 40.0, []
    for _ in range(steps):
        mid = (lo + hi) / 2
        # the rows, weighted by share, that the windows may still keep
        # before the average passes the target: once it has, the rest are
        # not merged and this bias is not a candidate
        budget = target * total
        for share, (props, valid, logits, deltas, hw) in zip(shares, outputs):
            shifted = logits.clone()
            shifted[..., 0] += mid
            kept = detections(cfg, props, valid, shifted, deltas, hw)
            budget -= share * merge(cfg, [((0, 0), kept)],
                                    math.floor(budget / share))["scores"].shape[0]
            if budget < 0:
                break
        count = target - budget / total
        if budget >= 0:
            tried.append((abs(count - target), mid))
            if abs(count - target) <= 0.01 * target:
                break
        if count > target:
            lo = mid
        else:
            hi = mid
    # the count steps as boxes cross the score threshold: the bias tried
    # whose count came nearest
    return with_background_bias(W, min(tried)[1])


# --- the trunk -------------------------------------------------------------------


class _Trunk:
    """Body, pyramid and RPN head over the weights ``W``, each conv's
    operands rounded by ``P``."""

    def __init__(self, W, cfg: dict, P: Precision):
        self.W, self.cfg, self.P = W, cfg, P

    def conv(self, x, name, stride=1, padding=0):
        bias = self.W.get(f"{name}.bias")
        return F.conv2d(self.P.rnd(x), self.P.rnd(self.W[f"{name}.weight"]), bias,
                        stride=stride, padding=padding)

    def bn(self, x, name):
        W = self.W
        scale = W[f"{name}.weight"] * torch.rsqrt(W[f"{name}.running_var"] + EPS)
        shift = W[f"{name}.bias"] - W[f"{name}.running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def body(self, x) -> List[torch.Tensor]:
        y = torch.relu(self.bn(self.conv(x, "backbone.body.conv1", 2, 3), "backbone.body.bn1"))
        y = F.max_pool2d(y, 3, 2, 1)
        feats, stage = [], "layer1"
        for prefix, _cin, _width, stride, projected in _body_layout(self.cfg):
            if prefix.split(".")[2] != stage:
                feats.append(y)
                stage = prefix.split(".")[2]
            t = torch.relu(self.bn(self.conv(y, f"{prefix}.conv1"), f"{prefix}.bn1"))
            t = torch.relu(self.bn(self.conv(t, f"{prefix}.conv2", stride, 1), f"{prefix}.bn2"))
            t = self.bn(self.conv(t, f"{prefix}.conv3"), f"{prefix}.bn3")
            if projected:
                y = self.bn(self.conv(y, f"{prefix}.downsample.0", stride),
                            f"{prefix}.downsample.1")
            y = torch.relu(t + y)
        feats.append(y)
        return feats

    def pyramid(self, feats) -> Dict[str, torch.Tensor]:
        inner = [self.conv(f, f"backbone.fpn.inner_blocks.{i}.0") for i, f in enumerate(feats)]
        top = [None] * len(inner)
        top[-1] = inner[-1]
        for i in range(len(inner) - 2, -1, -1):
            top[i] = inner[i] + upsample_nearest(top[i + 1], inner[i].shape[-2:])
        out = {f"p{i + 2}": self.conv(t, f"backbone.fpn.layer_blocks.{i}.0", padding=1)
               for i, t in enumerate(top)}
        out["p6"] = F.max_pool2d(out["p5"], 1, 2)
        return out

    def rpn(self, pyramid):
        out = {}
        for lvl in LEVELS:
            t = torch.relu(self.conv(pyramid[lvl], "rpn.head.conv.0.0", padding=1))
            out[lvl] = (self.conv(t, "rpn.head.cls_logits"), self.conv(t, "rpn.head.bbox_pred"))
        return out


def upsample_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``x`` [B, C, h, w] to ``size``: output row i reads input row
    ``floor((2i + 1) * h / (2 * H))`` (exact integer arithmetic)."""
    for axis, (n_in, n_out) in zip((2, 3), zip(x.shape[-2:], size)):
        idx = (torch.arange(n_out, device=x.device) * 2 + 1) * n_in // (2 * n_out)
        x = x.index_select(axis, idx)
    return x


def trunk(W, cfg: dict, images: torch.Tensor, P: Precision):
    """``images`` [B, H, W, 3] (a window's z-planes, channels last) to the
    pyramid (level -> [B, 256, h, w]) and the RPN's outputs (level ->
    objectness logits [B, A, h, w], deltas [B, 4A, h, w])."""
    with P.scope(), torch.no_grad():
        t = _Trunk(W, cfg, P)
        pyramid = t.pyramid(t.body(images.float().permute(0, 3, 1, 2)))
        return pyramid, t.rpn(pyramid)


# --- boxes -----------------------------------------------------------------------


def anchors(cfg: dict, level: str, h: int, w: int, device) -> torch.Tensor:
    """[h * w * A, 4] anchors of a level, location-major then ratio."""
    size = cfg["anchor_sizes"][LEVELS.index(level)]
    base = torch.tensor([[-size / math.sqrt(r) / 2, -size * math.sqrt(r) / 2,
                          size / math.sqrt(r) / 2, size * math.sqrt(r) / 2]
                         for r in cfg["anchor_ratios"]], dtype=torch.float64).float().to(device)
    s = STRIDE[level]
    ys = torch.arange(h, device=device, dtype=torch.float32) * s
    xs = torch.arange(w, device=device, dtype=torch.float32) * s
    shifts = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)] * 2, -1)
    return (shifts.reshape(-1, 1, 4) + base[None]).reshape(-1, 4)


def decode(ref: torch.Tensor, deltas: torch.Tensor, weights) -> torch.Tensor:
    """torchvision's ``BoxCoder.decode_single`` (x1, y1, x2, y2)."""
    widths = ref[..., 2] - ref[..., 0]
    heights = ref[..., 3] - ref[..., 1]
    cx = ref[..., 0] + 0.5 * widths
    cy = ref[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = torch.clamp(deltas[..., 2] / weights[2], max=DELTA_CLIP)
    dh = torch.clamp(deltas[..., 3] / weights[3], max=DELTA_CLIP)
    pcx, pcy = dx * widths + cx, dy * heights + cy
    half_w, half_h = 0.5 * (torch.exp(dw) * widths), 0.5 * (torch.exp(dh) * heights)
    return torch.stack([pcx - half_w, pcy - half_h, pcx + half_w, pcy + half_h], -1)


def clip(boxes: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    lim = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), lim)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torchvision's ``box_iou`` over [..., n, 4] and [..., m, 4]."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy NMS, one box at a time, batched over the leading axis:
    ``boxes`` [B, n, 4], ``scores`` [B, n] (-inf: not a candidate).  Visits
    each row's boxes in descending score (ties: lower index first), keeps a
    box no kept box overlaps above ``thr``; returns the keep mask [B, n]."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    s = scores.gather(1, order)
    over = iou_matrix(b, b) > thr
    alive = torch.isfinite(s)
    keep = torch.zeros_like(alive)
    for i in range(s.shape[1]):
        k = alive[:, i]
        keep[:, i] = k
        alive &= ~(over[:, i] & k[:, None])
    return torch.zeros_like(keep).scatter(1, order, keep)


def _top(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def proposals(cfg: dict, rpn, hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN's outputs to ``[B, P, 4]`` proposals and their ``[B, P]``
    validity: per level the top ``rpn_pre_nms_top_n`` objectness logits,
    their anchors decoded and clipped, boxes under 1e-3 wide or high
    dropped, NMS at ``rpn_nms_thresh``; then the top ``rpn_post_nms_top_n``
    over all levels."""
    boxes, scores = [], []
    with torch.no_grad():
        for lvl in LEVELS:
            logits, deltas = rpn[lvl]
            B, A, h, w = logits.shape
            obj = logits.float().permute(0, 2, 3, 1).reshape(B, -1)
            dl = deltas.float().reshape(B, A, 4, h, w).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
            top, idx = _top(obj, min(cfg["rpn_pre_nms_top_n"], obj.shape[1]))
            anc = anchors(cfg, lvl, h, w, obj.device)
            bx = clip(decode(anc[idx], dl.gather(1, idx[..., None].expand(-1, -1, 4)),
                             RPN_WEIGHTS), hw)
            big = ((bx[..., 2] - bx[..., 0]) >= 1e-3) & ((bx[..., 3] - bx[..., 1]) >= 1e-3)
            top = torch.where(big, top, -torch.inf)
            keep = greedy_nms(bx, top, cfg["rpn_nms_thresh"])
            boxes.append(bx)
            scores.append(torch.where(keep, top, -torch.inf))
        boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
        top, idx = _top(scores, min(cfg["rpn_post_nms_top_n"], scores.shape[1]))
        return boxes.gather(1, idx[..., None].expand(-1, -1, 4)), torch.isfinite(top)


# --- RoIAlign and the head -------------------------------------------------------


def _roi_align(fmap: torch.Tensor, img: torch.Tensor, boxes: torch.Tensor, scale: float,
               out: int, sr: int) -> torch.Tensor:
    """torchvision's ``roi_align`` (``aligned=False``) of [n] boxes from
    ``fmap`` [B, C, h, w]: [n, C, out, out]."""
    B, C, h, w = fmap.shape
    x1, y1, x2, y2 = (boxes[:, i] * scale for i in range(4))
    bin_w = torch.clamp(x2 - x1, min=1.0) / out
    bin_h = torch.clamp(y2 - y1, min=1.0) / out
    grid = torch.arange(out, device=boxes.device, dtype=torch.float32)
    sub = torch.arange(sr, device=boxes.device, dtype=torch.float32)
    # [n, out, sr]: bin p, sample i at start + p * bin + (i + 1/2) * bin / sr
    ys = y1[:, None, None] + grid[None, :, None] * bin_h[:, None, None] \
        + (sub[None, None, :] + 0.5) * bin_h[:, None, None] / sr
    xs = x1[:, None, None] + grid[None, :, None] * bin_w[:, None, None] \
        + (sub[None, None, :] + 0.5) * bin_w[:, None, None] / sr
    ys = ys[:, :, :, None, None].expand(-1, out, sr, out, sr)
    xs = xs[:, None, None, :, :].expand(-1, out, sr, out, sr)
    outside = (ys < -1.0) | (ys > h) | (xs < -1.0) | (xs > w)
    ys, xs = ys.clamp(min=0), xs.clamp(min=0)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y_top, x_top = y0 >= h - 1, x0 >= w - 1
    y0, x0 = torch.where(y_top, h - 1, y0), torch.where(x_top, w - 1, x0)
    ys, xs = torch.where(y_top, y0.float(), ys), torch.where(x_top, x0.float(), xs)
    y1i, x1i = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    ly, lx = ys - y0, xs - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    rows = fmap.permute(0, 2, 3, 1).reshape(B * h * w, C)
    base = img[:, None, None, None, None] * (h * w)

    def at(yi, xi):
        return rows.index_select(0, (base + yi * w + xi).reshape(-1)).reshape(*yi.shape, C)

    val = (at(y0, x0) * (hy * hx)[..., None] + at(y0, x1i) * (hy * lx)[..., None]
           + at(y1i, x0) * (ly * hx)[..., None] + at(y1i, x1i) * (ly * lx)[..., None])
    val = torch.where(outside[..., None], 0.0, val)
    return val.mean(dim=(2, 4)).permute(0, 3, 1, 2)


def roi_features(cfg: dict, pyramid, boxes: torch.Tensor, img: torch.Tensor,
                 chunk: int = 4096) -> torch.Tensor:
    """[n, 256, 7, 7] RoIAlign features of the boxes [n, 4] of planes
    ``img`` [n], each from the level its size maps to (p2..p5)."""
    area = torch.clamp((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), min=1e-6)
    level = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0)).clamp(2, 5).long()
    k = cfg["roi_align_output"]
    C = pyramid["p2"].shape[1]
    out = torch.zeros((boxes.shape[0], C, k, k), device=boxes.device)
    for n in (2, 3, 4, 5):
        sel = torch.nonzero(level == n).squeeze(1)
        for part in sel.split(chunk):
            out[part] = _roi_align(pyramid[f"p{n}"].float(), img[part], boxes[part],
                                   1.0 / STRIDE[f"p{n}"], k, cfg["roi_sampling_ratio"])
    return out


def head(W, cfg: dict, pyramid, boxes: torch.Tensor, img: torch.Tensor, P: Precision):
    """The box head over the boxes [n, 4] of planes ``img`` [n]: class
    logits [n, C] and per-class box deltas [n, 4C]."""
    with P.scope(), torch.no_grad():
        feats = roi_features(cfg, pyramid, boxes, img).flatten(1)

        def linear(x, name):
            return F.linear(P.rnd(x), P.rnd(W[f"{name}.weight"]), W[f"{name}.bias"])

        x = torch.relu(linear(feats, "roi_heads.box_head.fc6"))
        x = torch.relu(linear(x, "roi_heads.box_head.fc7"))
        return linear(x, CLS), linear(x, "roi_heads.box_predictor.bbox_pred")


def detections(cfg: dict, props: torch.Tensor, valid: torch.Tensor, logits: torch.Tensor,
               deltas: torch.Tensor, hw) -> List[Dict[str, torch.Tensor]]:
    """The box stage of each plane from its proposals [B, P, 4] (``valid``
    [B, P]) and the head's outputs [B, P, C], [B, P, 4C]: softmax, per-class
    decode and clip, the background dropped, scores over
    ``box_score_thresh``, boxes at least 1e-2 wide and high, per-class NMS at
    ``box_nms_thresh``, the top ``box_detections_per_img``.  Each plane's
    ``boxes``, ``scores`` and ``labels``, by descending score."""
    n_cls = cfg["num_classes"]
    B, n = props.shape[:2]
    with torch.no_grad():
        prob = torch.softmax(logits.float(), -1)
        dl = deltas.float().reshape(B, n, n_cls, 4).permute(0, 2, 1, 3)
        boxes = clip(decode(props[:, None], dl, BOX_WEIGHTS), hw)[:, 1:]  # [B, C - 1, n, 4]
        scores = prob.permute(0, 2, 1)[:, 1:]                             # class-major
        labels = torch.arange(1, n_cls, device=props.device)[None, :, None].expand_as(scores)
        boxes, scores, labels = boxes.reshape(B, -1, 4), scores.reshape(B, -1), labels.reshape(B, -1)
        ok = (valid.repeat(1, n_cls - 1) & (scores > cfg["box_score_thresh"])
              & ((boxes[..., 2] - boxes[..., 0]) >= 1e-2)
              & ((boxes[..., 3] - boxes[..., 1]) >= 1e-2))
        # each plane's candidates to the front, in order, for one batched NMS
        m = max(int(ok.sum(1).max()), 1)
        front = torch.sort((~ok).to(torch.uint8), dim=1, stable=True).indices[:, :m]
        boxes, labels = boxes.gather(1, front[..., None].expand(-1, -1, 4)), labels.gather(1, front)
        scores = torch.where(ok.gather(1, front), scores.gather(1, front), -torch.inf)
        keep = greedy_nms(boxes + labels[..., None].float() * (max(hw) + 2.0), scores,
                          cfg["box_nms_thresh"])
        top, idx = _top(torch.where(keep, scores, -torch.inf), cfg["box_detections_per_img"])
        out = []
        for b in range(B):
            i = idx[b][torch.isfinite(top[b])]
            out.append({"boxes": boxes[b][i], "scores": scores[b][i], "labels": labels[b][i]})
        return out


def stages(W, cfg: dict, images: torch.Tensor, P: Precision) -> dict:
    """The whole detector over a window's planes ``images`` [B, H, W, 3]:
    every stage's output, the program's ``Detector.detect_stages`` keys."""
    hw = tuple(images.shape[1:3])
    pyramid, rpn = trunk(W, cfg, images, P)
    props, valid = proposals(cfg, rpn, hw)
    B, n = props.shape[:2]
    img = torch.arange(B, device=props.device).repeat_interleave(n)
    logits, deltas = head(W, cfg, pyramid, props.reshape(-1, 4), img, P)
    logits, deltas = logits.reshape(B, n, -1), deltas.reshape(B, n, -1)
    return {"pyramid": pyramid, "rpn": rpn, "proposals": props, "proposal_valid": valid,
            "class_logits": logits, "box_deltas": deltas,
            "detections": detections(cfg, props, valid, logits, deltas, hw)}


# --- the chunk: tiles over the plane and the merge -------------------------------


def axis_windows(pad: int, core: int, n: int) -> List[Tuple[int, int]]:
    """``hcat/utils.py::calculate_indexes(pad, core, n, n)``: windows
    ``[start, stop)`` of one axis.  The whole axis where it is under
    ``core + 2 pad``; else windows of ``core + 2 pad - 1`` at every multiple
    of ``core`` that fits, and one more ending at ``n - 1``; where none fits,
    ``[0, core + 2 pad)`` and ``[n - core - 2 pad, n)``."""
    width = core + 2 * pad
    if n < width:
        return [(0, n)]
    out = []
    for start in range(0, n, core)[:-1]:
        if start + core + 2 * pad - 1 >= n:
            break
        out.append((start, start + width - 1))
    if not out:
        return [(0, width), (n - width, n)]
    return out + [(n - width, n - 1)]


def tile_grid(cfg: dict, X: int, Y: int) -> List[Tuple[int, int, int, int]]:
    """The windows ``(x0, x1, y0, y1)`` of an ``X x Y`` plane, x outer:
    ``hcat/segment.py``'s grid with the configuration's core and pad,
    repeats included."""
    (cx, cy), (px, py) = cfg["tiles"]["eval_size"], cfg["tiles"]["pad"]
    return [(x0, x1, y0, y1) for x0, x1 in axis_windows(px, min(cx, X), X)
            for y0, y1 in axis_windows(py, min(cy, Y), Y)]


def _nms_host(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy NMS of one list on the host: kept indices by descending score
    (ties: lower index first)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (iou_matrix(boxes[order], boxes[order]) > thr).numpy()
    gone = np.zeros(len(order), bool)
    kept = []
    for i in range(len(order)):
        if not gone[i]:
            kept.append(i)
            gone |= over[i]
    return order[torch.tensor(kept, dtype=torch.long)]


def merge(cfg: dict, windows, cap: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``hcat/utils.py::merge_cell_candidates`` over a chunk: for each window
    ``((x0, y0), planes)`` in the grid's order and each of its planes in
    order (a plane's detections as :func:`detections` gives them, with
    scores over 0), the boxes moved to the volume's axes ``(y1, x1, y2,
    x2)`` and by the window's origin, appended to the list, and the list
    reduced by greedy NMS at ``merge_iou``.  Host float32 tensors ``boxes``
    [n, 4], ``scores``, ``labels``, ``z_level``; with ``cap``, the list as
    it stands once it holds more than ``cap`` rows."""
    keys = ("boxes", "scores", "labels", "z_level")
    merged = None
    for (x0, y0), planes in windows:
        for z, det in enumerate(planes):
            ok = det["scores"] > 0
            if not bool(ok.any()):
                continue
            b = det["boxes"][ok].float().cpu()
            new = {"boxes": b[:, [1, 0, 3, 2]] + torch.tensor([x0, y0, x0, y0],
                                                             dtype=torch.float32),
                   "scores": det["scores"][ok].float().cpu(),
                   "labels": det["labels"][ok].cpu().to(torch.int32),
                   "z_level": torch.full((int(ok.sum()),), float(z))}
            merged = new if merged is None else {k: torch.cat([merged[k], new[k]]) for k in keys}
            keep = _nms_host(merged["boxes"], merged["scores"], cfg["merge_iou"])
            merged = {k: v[keep] for k, v in merged.items()}
            if cap is not None and len(keep) > cap:
                return merged
    if merged is None:
        return {"boxes": torch.zeros((0, 4)), "scores": torch.zeros(0),
                "labels": torch.zeros(0, dtype=torch.int32), "z_level": torch.zeros(0)}
    return merged


def detect_chunk(W, cfg: dict, image: torch.Tensor, P: Precision) -> Dict[str, torch.Tensor]:
    """The whole reference on a chunk ``image`` [X, Y, Z, 3] (the
    detector's channels): every window's planes through :func:`stages`,
    merged."""
    X, Y = image.shape[:2]
    windows = []
    for x0, x1, y0, y1 in tile_grid(cfg, X, Y):
        dets = stages(W, cfg, image[x0:x1, y0:y1].movedim(2, 0), P)["detections"]
        windows.append(((x0, y0), dets))
    return merge(cfg, windows)


def window_sizes(cfg: dict, X: int, Y: int) -> List[Sequence[int]]:
    """``(H, W)`` of each window the grid runs, repeats included."""
    return [(x1 - x0, y1 - y0) for x0, x1, y0, y1 in tile_grid(cfg, X, Y)]
