"""The detector's model FLOPs, from the configuration and the plane's size
alone (never from the program): the frozen arithmetic of the
``frcnn-r50fpn-hcat`` cell's ``mfu_pct.detect``.

A conv counts out_h x out_w x k^2 x Cin x Cout multiply-adds, a linear layer
in x out; batch norms, ReLUs, pools, the upsample-adds, RoIAlign, decoding
and NMS count nothing.  Every plane of a window runs the body, the pyramid,
the RPN head over p2..p6 and the box head over the ``rpn_post_nms_top_n``
proposal rows the program computes (the valid ones and the padding alike).
"""

from __future__ import annotations

from typing import Dict, Sequence


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def body_macs(cfg: dict, h: int, w: int):
    """The ResNet body's multiply-adds over an ``h x w`` plane, and the
    sizes ``(h, w, channels)`` of c2..c5."""
    width, x4 = cfg["width"], cfg["bottleneck_expansion"]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = h * w * 49 * 3 * width
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the max pool
    cin, sizes = width, []
    for stage, n in enumerate(cfg["stage_sizes"]):
        f = width * 2 ** stage
        for b in range(n):
            s = 2 if (b == 0 and stage > 0) else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            macs += h * w * cin * f + ho * wo * 9 * f * f + ho * wo * f * f * x4
            if cin != f * x4 or s != 1:
                macs += _out(h, 1, s, 0) * _out(w, 1, s, 0) * cin * f * x4
            h, w, cin = ho, wo, f * x4
        sizes.append((h, w, cin))
    return macs, sizes


def plane_macs(cfg: dict, h: int, w: int) -> Dict[str, float]:
    """Multiply-adds of one ``h x w`` plane through the detector, by part:
    ``body``, ``fpn``, ``rpn``, ``head``."""
    body, sizes = body_macs(cfg, h, w)
    c = cfg["fpn_channels"]
    fpn = sum(fh * fw * (cin * c + 9 * c * c) for fh, fw, cin in sizes)
    levels = [(fh, fw) for fh, fw, _ in sizes]
    levels.append((_out(levels[-1][0], 1, 2, 0), _out(levels[-1][1], 1, 2, 0)))  # p6
    a = len(cfg["anchor_ratios"])
    rpn = sum(fh * fw * (9 * c * c + c * 5 * a) for fh, fw in levels)
    anchors = sum(min(cfg["rpn_pre_nms_top_n"], fh * fw * a) for fh, fw in levels)
    rows = min(cfg["rpn_post_nms_top_n"], anchors)
    k, rep, n_cls = cfg["roi_align_output"], cfg["representation_size"], cfg["num_classes"]
    head = rows * (c * k * k * rep + rep * rep + rep * 5 * n_cls)
    return {"body": float(body), "fpn": float(fpn), "rpn": float(rpn), "head": float(head)}


def windows_flops(cfg: dict, windows: Sequence[Sequence[int]], planes: int) -> float:
    """FLOPs (2 x multiply-adds) of ``planes`` planes through each window
    ``(h, w)`` of a chunk's grid."""
    return 2.0 * planes * sum(sum(plane_macs(cfg, h, w).values()) for h, w in windows)
