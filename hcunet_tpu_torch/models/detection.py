"""Faster R-CNN style detector (twin of ``hcunet_tpu/models/detection.py``).

``Detector(config).detect(images[B, H, W, 3])`` returns the JAX package's
dict of ``[B, K, ...]`` tensors — ``boxes`` ``(x1, y1, x2, y2)`` with x the
width axis, ``scores``, ``labels`` and ``valid`` — with ``K`` the static
``max_detections`` and ``valid`` marking the real rows.  The JAX ``vmap``
over images is a batch dimension written out: the trunk, the per-level
proposal NMS, RoIAlign, the box head and the class-offset NMS each run once
for all images of the batch.

The modules keep torchvision's ``fasterrcnn_resnet50_fpn`` names
(``backbone.body``, ``backbone.fpn``, ``rpn.head``, ``roi_heads.box_head``,
``roi_heads.box_predictor``), so ``hcunet_tpu/utils/port_torchvision.py``
reads this module's state dict and a torchvision checkpoint loads as it is.
The box head flattens its ``[N, C, 7, 7]`` RoI features in torchvision's
(C, H, W) order; the JAX package flattens (H, W, C), and
:func:`hcunet_tpu_torch.utils.port_jax.detector_state_dict_from_jax_variables`
permutes ``fc6`` to match.

``losses(images[1, H, W, 3], gt_boxes, gt_labels, gt_valid)`` is the JAX
``Detector.losses``: the four torchvision loss terms of one image against
its ground truth padded to a static ``max_gt``, with the trunk in training
mode (flax's batch-norm rule), and the trunk's new running statistics
returned rather than kept (the module's buffers come back as they were),
as the JAX function returns its ``batch_stats`` update.

Ties are broken as in the JAX package: ``lax.top_k`` takes the lower index
first, so top-k here is a stable descending sort; the NMS order is a stable
argsort; ``torch.argmax`` takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hcunet_tpu_torch.config import DetectorConfig, resolve_device
from hcunet_tpu_torch.models.fpn import FPN
from hcunet_tpu_torch.models.resnet import BatchNorm, ResNet, SmallBackbone
from hcunet_tpu_torch.ops.nms import box_iou, nms_mask
from hcunet_tpu_torch.ops.roi_align import roi_align

LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


# ---------------------------------------------------------------------------
# anchors + box coding
# ---------------------------------------------------------------------------


def generate_anchors(
    feat_shapes: Dict[str, Tuple[int, int]],
    sizes: Sequence[int],
    ratios: Sequence[float],
    device=None,
) -> Dict[str, torch.Tensor]:
    """Per-level anchor boxes ``[H*W*A, 4]`` in input coordinates, ordered
    (row, column, ratio)."""
    out = {}
    for lvl, size in zip(LEVELS, sizes):
        h, w = feat_shapes[lvl]
        stride = STRIDES[lvl]
        base = []
        for r in ratios:
            area = float(size) ** 2
            aw = (area / r) ** 0.5
            ah = aw * r
            base.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        base = torch.tensor(np.asarray(base, np.float32), device=device)  # [A, 4]
        ys = torch.arange(h, dtype=torch.float32, device=device) * stride
        xs = torch.arange(w, dtype=torch.float32, device=device) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        centers = torch.stack(
            [cx.reshape(-1), cy.reshape(-1), cx.reshape(-1), cy.reshape(-1)], dim=1
        )
        out[lvl] = (centers[:, None, :] + base[None, :, :]).reshape(-1, 4)
    return out


def encode_boxes(ref: torch.Tensor, gt: torch.Tensor, weights) -> torch.Tensor:
    """torchvision BoxCoder.encode: deltas taking ``ref`` to ``gt``."""
    wx, wy, ww, wh = weights
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    rw = rw.clamp(min=1e-4)
    rh = rh.clamp(min=1e-4)
    return torch.stack(
        [
            wx * (gx - rx) / rw,
            wy * (gy - ry) / rh,
            ww * torch.log(gw.clamp(min=1e-4) / rw),
            wh * torch.log(gh.clamp(min=1e-4) / rh),
        ],
        dim=-1,
    )


def decode_boxes(ref: torch.Tensor, deltas: torch.Tensor, weights) -> torch.Tensor:
    wx, wy, ww, wh = weights
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw, dh = deltas[..., 2] / ww, deltas[..., 3] / wh
    dw = dw.clamp(-10.0, 4.135)  # torchvision clamps to log(1000/16)
    dh = dh.clamp(-10.0, 4.135)
    cx = dx * rw + rx
    cy = dy * rh + ry
    w = torch.exp(dw) * rw
    h = torch.exp(dh) * rh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    return torch.stack(
        [
            boxes[..., 0].clamp(0, w),
            boxes[..., 1].clamp(0, h),
            boxes[..., 2].clamp(0, w),
            boxes[..., 3].clamp(0, h),
        ],
        dim=-1,
    )


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax**2 / beta, ax - 0.5 * beta)


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, lower index first on
    ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x`` ``[B, N, ...]`` and ``idx`` ``[B, K]``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


# ---------------------------------------------------------------------------
# network modules
# ---------------------------------------------------------------------------


class BackboneWithFPN(nn.Module):
    """torchvision's ``backbone``: ``body`` (ResNet or small) and ``fpn``."""

    def __init__(self, backbone: str, width: int, fpn_channels: int = 256):
        super().__init__()
        if backbone == "resnet50":
            self.body = ResNet(width=width)
        elif backbone == "small":
            self.body = SmallBackbone()
        else:
            raise ValueError(f"unknown backbone {backbone}")
        self.fpn = FPN(self.body.out_channels, fpn_channels)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.fpn(self.body(images))


class RPNHead(nn.Module):
    """3x3 conv + ReLU shared over levels, then objectness logits and box
    deltas per anchor (torchvision names: ``conv.0.0``, ``cls_logits``,
    ``bbox_pred``)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU())
        )
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.conv(feat)
        return self.cls_logits(t), self.bbox_pred(t)


class _RPN(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.head = RPNHead(channels, num_anchors)


class BoxHead(nn.Module):
    """torchvision's ``TwoMLPHead`` (``fc6``, ``fc7``) over RoI features
    flattened in (C, H, W) order.  The JAX ``BoxHead`` also holds the two
    output layers, which torchvision keeps in :class:`BoxPredictor`."""

    def __init__(self, in_features: int, representation: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation)
        self.fc7 = nn.Linear(representation, representation)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:  # [N, C, 7, 7]
        x = F.relu(self.fc6(rois.flatten(1)))
        return F.relu(self.fc7(x))


class BoxPredictor(nn.Module):
    """torchvision's ``FastRCNNPredictor``: class logits and per-class box
    deltas."""

    def __init__(self, representation: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(representation, num_classes)
        self.bbox_pred = nn.Linear(representation, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class RoIClassifier(nn.Module):
    """torchvision's ``roi_heads``: box head and predictor."""

    def __init__(self, config: DetectorConfig, channels: int = 256, representation: int = 1024):
        super().__init__()
        k = config.roi_align_output
        self.box_head = BoxHead(channels * k * k, representation)
        self.box_predictor = BoxPredictor(representation, config.num_classes)

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``roi_feats`` ``[N, 7, 7, C]`` channels-last, as the JAX head
        takes them."""
        return self.box_predictor(self.box_head(roi_feats.permute(0, 3, 1, 2)))


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN head, returning the pyramid and the raw
    per-level RPN outputs (NCHW)."""

    def __init__(self, config: DetectorConfig, backbone: str = "resnet50",
                 backbone_width: int = 64):
        super().__init__()
        self.config = config
        self.backbone_name = backbone
        self.backbone = BackboneWithFPN(backbone, backbone_width)
        self.rpn = _RPN(256, len(config.anchor_ratios))

    def forward(self, images: torch.Tensor):
        """``images`` ``[B, 3, H, W]``."""
        pyramid = self.backbone(images)
        rpn_out = {lvl: self.rpn.head(pyramid[lvl]) for lvl in LEVELS}
        return pyramid, rpn_out


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


class Detector(FasterRCNN):
    """The trunk, the RoI heads and the proposal/postprocessing pipeline.

    Built on ``device`` (CUDA unless given) in ``dtype``, in eval mode: the
    batch norms run with their running statistics, except inside
    :meth:`losses` with ``train=True``."""

    RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)

    def __init__(self, config: DetectorConfig = DetectorConfig(),
                 backbone: str = "resnet50", dtype: torch.dtype = torch.float32,
                 backbone_width: int = 64, device=None):
        super().__init__(config, backbone, backbone_width)
        self.roi_heads = RoIClassifier(config)
        self.device = resolve_device(device)
        self.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype

    # -- proposals ----------------------------------------------------------

    def _proposals(self, rpn_out, anchors, hw):
        """Per-level top-k, decode, clip, per-level NMS, then the global
        top-k: ``[B, P, 4]`` proposals and their ``[B, P]`` validity."""
        cfg = self.config
        all_boxes, all_scores = [], []
        for lvl in LEVELS:
            logits, deltas = rpn_out[lvl]
            B = logits.shape[0]
            # NCHW -> the JAX (row, column, anchor) order
            scores = logits.permute(0, 2, 3, 1).reshape(B, -1).float()
            deltas = deltas.permute(0, 2, 3, 1).reshape(B, -1, 4).float()
            k = min(cfg.rpn_pre_nms_top_n, scores.shape[1])
            top_scores, idx = _top_k(scores, k)
            boxes = decode_boxes(anchors[lvl][idx], _take(deltas, idx), self.RPN_WEIGHTS)
            boxes = clip_boxes(boxes, hw)
            # NMS within the level (torchvision's batched_nms with the level
            # as the batch id)
            wh_ok = (boxes[..., 2] > boxes[..., 0] + 1e-3) & (
                boxes[..., 3] > boxes[..., 1] + 1e-3
            )
            lvl_scores = torch.where(wh_ok, top_scores, -torch.inf)
            keep = nms_mask(boxes, lvl_scores, cfg.rpn_nms_thresh)
            all_boxes.append(boxes)
            all_scores.append(torch.where(keep, lvl_scores, -torch.inf))
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        top, idx = _top_k(scores, min(cfg.rpn_post_nms_top_n, scores.shape[1]))
        return _take(boxes, idx), torch.isfinite(top)

    # -- RoI features (FPN level assignment) --------------------------------

    def _roi_features(self, pyramid, boxes):
        """``[B, P, 7, 7, C]`` RoIAlign features, each box pooled from its
        FPN level (p2..p5) only."""
        cfg = self.config
        B, P = boxes.shape[:2]
        flat = boxes.reshape(-1, 4)
        img = torch.arange(B, device=boxes.device).repeat_interleave(P)
        w = flat[:, 2] - flat[:, 0]
        h = flat[:, 3] - flat[:, 1]
        area = torch.clamp(w * h, min=1e-6)
        k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0))
        k = k.clamp(2, 5).long()
        out_k = cfg.roi_align_output
        C = pyramid["p2"].shape[1]
        feats = torch.zeros((B * P, out_k, out_k, C), device=boxes.device, dtype=torch.float32)
        for lvl in ("p2", "p3", "p4", "p5"):
            sel = torch.nonzero(k == int(lvl[1])).squeeze(1)
            if sel.numel() == 0:
                continue
            fmap = pyramid[lvl].float().permute(0, 2, 3, 1).contiguous()
            feats[sel] = roi_align(
                fmap, flat[sel], 1.0 / STRIDES[lvl], out_k, 2, batch_index=img[sel]
            )
        return feats.reshape(B, P, out_k, out_k, C)

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def detect(self, images) -> Dict[str, torch.Tensor]:
        """``images``: ``[B, H, W, 3]`` channels-last float (numpy or
        tensor), moved to the detector's device.  Returns a dict of
        ``[B, K, ...]`` tensors on that device."""
        return self.detect_stages(images)["detections"]

    @torch.no_grad()
    def detect_stages(self, images) -> Dict[str, object]:
        """:meth:`detect`'s work with each stage's output kept: ``pyramid``
        (per level, NCHW), ``rpn`` (per level, the NCHW objectness logits
        and box deltas), ``proposals`` ``[B, P, 4]`` and ``proposal_valid``
        ``[B, P]``, the head's ``class_logits`` ``[B, P, C]`` and
        ``box_deltas`` ``[B, P, 4C]``, and ``detections``, what
        :meth:`detect` returns."""
        cfg = self.config
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(device=self.device, dtype=self.dtype)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [B, H, W, 3] images, got {tuple(images.shape)}")
        hw = tuple(images.shape[1:3])
        pyramid, rpn_out = self(images.permute(0, 3, 1, 2))
        feat_shapes = {lvl: tuple(pyramid[lvl].shape[-2:]) for lvl in LEVELS}
        anchors = generate_anchors(
            feat_shapes, cfg.anchor_sizes, cfg.anchor_ratios, device=self.device
        )
        props, pvalid = self._proposals(rpn_out, anchors, hw)
        cls_logits, reg = self._head(pyramid, props)
        return {
            "pyramid": pyramid,
            "rpn": rpn_out,
            "proposals": props,
            "proposal_valid": pvalid,
            "class_logits": cls_logits,
            "box_deltas": reg,
            "detections": self._detections(props, pvalid, cls_logits, reg, hw),
        }

    def _head(self, pyramid, props):
        """The RoI heads over the proposals ``[B, P, 4]``: class logits
        ``[B, P, C]`` and per-class box deltas ``[B, P, 4C]``."""
        B, n_prop = props.shape[:2]
        roi_feats = self._roi_features(pyramid, props)
        cls_logits, reg = self.roi_heads(
            roi_feats.reshape(B * n_prop, *roi_feats.shape[2:]).to(self.dtype)
        )
        return cls_logits.reshape(B, n_prop, -1), reg.reshape(B, n_prop, -1)

    def _detections(self, props, pvalid, cls_logits, reg, hw):
        """Per-class decode, the score and size rules, one NMS over all
        classes via a class offset, and the top ``max_detections``."""
        cfg = self.config
        B, n_prop = props.shape[:2]
        probs = torch.softmax(cls_logits.float(), dim=-1)
        n_cls = cfg.num_classes
        reg = reg.float().reshape(B, n_prop, n_cls, 4)
        boxes_c = clip_boxes(
            decode_boxes(props[:, None], reg.permute(0, 2, 1, 3), self.BOX_WEIGHTS), hw
        )  # [B, C, P, 4]
        scores_c = probs.permute(0, 2, 1)  # [B, C, P]
        # drop background class 0
        boxes_f = boxes_c[:, 1:].reshape(B, -1, 4)
        scores_f = scores_c[:, 1:].reshape(B, -1)
        labels_f = torch.arange(1, n_cls, device=self.device).repeat_interleave(n_prop)
        valid_f = (
            pvalid.repeat(1, n_cls - 1)
            & (scores_f > cfg.box_score_thresh)
            & (boxes_f[..., 2] > boxes_f[..., 0] + 1e-2)
            & (boxes_f[..., 3] > boxes_f[..., 1] + 1e-2)
        )
        offset = labels_f.float()[:, None] * (max(hw) + 2.0)
        keep = nms_mask(
            boxes_f + offset, torch.where(valid_f, scores_f, -torch.inf),
            cfg.box_nms_thresh,
        )
        final_scores = torch.where(keep & valid_f, scores_f, -torch.inf)
        top, idx = _top_k(final_scores, min(cfg.max_detections, final_scores.shape[1]))
        found = torch.isfinite(top)
        return {
            "boxes": _take(boxes_f, idx),
            "scores": torch.where(found, top, 0.0),
            "labels": torch.where(found, labels_f[idx], 0),
            "valid": found,
        }

    # -- training -----------------------------------------------------------

    def losses(
        self,
        images: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
        train: bool = True,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Single-image (B=1) loss dict, ``images`` ``[1, H, W, 3]``
        channels-last on the detector's device; ``gt_boxes`` ``[G, 4]``,
        ``gt_labels`` ``[G]`` and ``gt_valid`` ``[G]`` (bool) padded to a
        static ``G``.

        Returns ``(losses, new_stats)``: the four terms
        (``loss_objectness``, ``loss_rpn_box_reg``, ``loss_classifier``,
        ``loss_box_reg``) as float32 scalars with their graph, and, with
        ``train``, the trunk's new running statistics under their state-dict
        names (the buffers themselves are left as they were), else ``{}``.
        Anchors are positive at IoU >= 0.7 and negative below 0.3, each
        real box's best anchor positive too; the head takes the proposals
        and the real boxes (no gradient through either), positive at IoU
        >= 0.5."""
        cfg = self.config
        hw = tuple(images.shape[1:3])
        bns = [(n, m) for n, m in self.backbone.body.named_modules() if isinstance(m, BatchNorm)]
        start = [(m.running_mean.clone(), m.running_var.clone()) for _n, m in bns]
        was = self.training
        self.train(train)
        try:
            pyramid, rpn_out = self(images.permute(0, 3, 1, 2))
        finally:
            self.train(was)
        new_stats = {}
        if train:
            for (name, m), (mean, var) in zip(bns, start):
                prefix = f"backbone.body.{name}"
                new_stats[f"{prefix}.running_mean"] = m.running_mean.clone()
                new_stats[f"{prefix}.running_var"] = m.running_var.clone()
                with torch.no_grad():
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)

        feat_shapes = {lvl: tuple(pyramid[lvl].shape[-2:]) for lvl in LEVELS}
        anchors_d = generate_anchors(
            feat_shapes, cfg.anchor_sizes, cfg.anchor_ratios, device=images.device
        )
        anchors = torch.cat([anchors_d[lvl] for lvl in LEVELS])
        # NCHW -> the JAX (row, column, anchor) order, as in _proposals
        obj_logits = torch.cat(
            [rpn_out[lvl][0][0].permute(1, 2, 0).reshape(-1) for lvl in LEVELS]
        ).float()
        rpn_deltas = torch.cat(
            [rpn_out[lvl][1][0].permute(1, 2, 0).reshape(-1, 4) for lvl in LEVELS]
        ).float()
        gt_boxes = gt_boxes.float()

        # --- RPN targets ---
        iou = box_iou(anchors, gt_boxes)  # [A, G]
        iou = torch.where(gt_valid[None, :], iou, -1.0)
        best_iou = iou.max(dim=1).values
        best_gt = iou.argmax(dim=1)  # the first maximum, as jnp.argmax
        pos = best_iou >= 0.7
        # every real box's best anchor is positive too; a max-scatter, so
        # that a padded slot (whose argmax is anchor 0) cannot clear a True
        # written for a real box at the same index
        force = torch.zeros(anchors.shape[0], device=anchors.device).scatter_reduce(
            0, iou.argmax(dim=0), gt_valid.float(), "amax"
        )
        pos = pos | (force > 0)
        neg = (best_iou < 0.3) & ~pos
        matched_gt = gt_boxes[best_gt]

        obj_target = pos.float()
        obj_weight = (pos | neg).float()
        bce = (
            torch.clamp(obj_logits, min=0)
            - obj_logits * obj_target
            + torch.log1p(torch.exp(-torch.abs(obj_logits)))
        )
        n_sampled = torch.clamp(obj_weight.sum(), min=1.0)
        loss_objectness = (bce * obj_weight).sum() / n_sampled
        rpn_reg_target = encode_boxes(anchors, matched_gt, self.RPN_WEIGHTS)
        loss_rpn_box = (
            smooth_l1(rpn_deltas - rpn_reg_target, 1.0 / 9.0).sum(dim=1) * pos.float()
        ).sum() / n_sampled

        # --- proposals for the head, plus the ground-truth boxes ---
        with torch.no_grad():
            props, pvalid = self._proposals(rpn_out, anchors_d, hw)
            props = torch.cat([props[0], gt_boxes])
            pvalid = torch.cat([pvalid[0], gt_valid])
            piou = box_iou(props, gt_boxes)
            piou = torch.where(gt_valid[None, :] & pvalid[:, None], piou, -1.0)
            p_best_iou = piou.max(dim=1).values
            p_best_gt = piou.argmax(dim=1)
            p_pos = p_best_iou >= 0.5
            p_neg = (p_best_iou < 0.5) & (p_best_iou >= 0.0) & pvalid
            cls_target = torch.where(p_pos, gt_labels.long()[p_best_gt], 0)
            head_reg_target = encode_boxes(props, gt_boxes[p_best_gt], self.BOX_WEIGHTS)

        roi_feats = self._roi_features(pyramid, props[None])[0]
        cls_logits, reg = self.roi_heads(roi_feats.to(self.dtype))
        logp = torch.log_softmax(cls_logits.float(), dim=-1)
        ce = -logp.gather(1, cls_target[:, None])[:, 0]
        cls_weight = (p_pos | p_neg).float()
        n_roi = torch.clamp(cls_weight.sum(), min=1.0)
        loss_classifier = (ce * cls_weight).sum() / n_roi

        reg = reg.float().reshape(props.shape[0], cfg.num_classes, 4)
        reg_sel = reg.gather(1, cls_target[:, None, None].expand(-1, 1, 4))[:, 0]
        loss_box_reg = (
            smooth_l1(reg_sel - head_reg_target, 1.0).sum(dim=1) * p_pos.float()
        ).sum() / n_roi

        losses = {
            "loss_objectness": loss_objectness,
            "loss_rpn_box_reg": loss_rpn_box,
            "loss_classifier": loss_classifier,
            "loss_box_reg": loss_box_reg,
        }
        return losses, new_stats
