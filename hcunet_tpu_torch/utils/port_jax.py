"""Carry weights between the JAX package's variable trees and the port.

The JAX package keeps ``{"params", "batch_stats"}`` trees
(``hcunet_tpu/models/unet.py``, ``models/detection.py``); the port keeps the
reference ``Unet_Constructor`` state dict and torchvision's
``fasterrcnn_resnet50_fpn`` names.  These are the port's own copy of the
layout rules of ``hcunet_tpu/utils/port_torch.py``, on numpy arrays:

* conv weight: JAX ``[*k, Cin/g, Cout]`` ↔ torch ``[Cout, Cin/g, *k]``;
* transpose-conv weight: JAX ``[*k, Cin, Cout]`` ↔ torch ``[Cin, Cout, *k]``;
* BatchNorm ``scale/bias/mean/var`` ↔ ``weight/bias/running_mean/running_var``.

Optax's Adam moments have their parameters' layouts, so the optimizer
state crosses with the same rules (:func:`torch_adam_state_from_optax`,
:func:`optax_adam_state_from_torch`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from hcunet_tpu_torch.config import UNetConfig

_PAIRS = (("conv1", "batch1"), ("conv2", "batch2"))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def _conv_to_torch(w) -> torch.Tensor:
    w = np.asarray(w)
    nd = w.ndim - 2
    return _t(np.transpose(w, (nd + 1, nd) + tuple(range(nd))))


def _tconv_to_torch(w) -> torch.Tensor:
    w = np.asarray(w)
    nd = w.ndim - 2
    return _t(np.transpose(w, (nd, nd + 1) + tuple(range(nd))))


def _conv_to_jax(t) -> np.ndarray:
    w = _np(t)
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def _tconv_to_jax(t) -> np.ndarray:
    w = _np(t)
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (0, 1))


def unet_state_dict_from_jax_variables(
    variables: Mapping, config: UNetConfig
) -> Dict[str, torch.Tensor]:
    """State dict of :class:`hcunet_tpu_torch.models.unet.UNet` from the JAX
    ``{"params", "batch_stats"}`` tree (numpy or array-like leaves).  A tree
    without ``batch_stats`` (an optimizer moment, say) gives the parameters
    alone, under the same names."""
    params, stats = variables["params"], variables.get("batch_stats")
    n = len(config.feature_sizes)
    sd: Dict[str, torch.Tensor] = {}

    def put_block(prefix: str, p: Mapping, s: Mapping | None):
        for j, (conv, bn) in enumerate(_PAIRS):
            pj = p[f"ConvBNRelu_{j}"]
            sd[f"{prefix}.{conv}.weight"] = _conv_to_torch(pj["kernel"])
            sd[f"{prefix}.{conv}.bias"] = _t(pj["bias"])
            sd[f"{prefix}.{bn}.weight"] = _t(pj["BatchNorm_0"]["scale"])
            sd[f"{prefix}.{bn}.bias"] = _t(pj["BatchNorm_0"]["bias"])
            if s is None:
                continue
            sj = s[f"ConvBNRelu_{j}"]
            sd[f"{prefix}.{bn}.running_mean"] = _t(sj["BatchNorm_0"]["mean"])
            sd[f"{prefix}.{bn}.running_var"] = _t(sj["BatchNorm_0"]["var"])
            sd[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(0)

    for i in range(n):
        put_block(f"down_steps.{i}", params[f"down{i}"], stats and stats[f"down{i}"])
    for i in range(n - 1):
        p = params[f"up{i}"]
        sd[f"up_steps.{i}.up_conv.weight"] = _tconv_to_torch(p["up_kernel"])
        sd[f"up_steps.{i}.up_conv.bias"] = _t(p["up_bias"])
        put_block(f"up_steps.{i}", p, stats and stats[f"up{i}"])
    sd["out_conv.weight"] = _conv_to_torch(params["out_kernel"])
    sd["out_conv.bias"] = _t(params["out_bias"])
    return sd


def jax_variables_from_unet_state_dict(sd: Mapping, config: UNetConfig) -> Dict:
    """Inverse of :func:`unet_state_dict_from_jax_variables`: the JAX
    ``{"params", "batch_stats"}`` tree, as numpy arrays, from the port's
    (or the reference's) state dict; ``{"params"}`` alone where ``sd``
    holds no running statistics."""
    n = len(config.feature_sizes)
    params: Dict = {}
    stats: Dict = {}
    with_stats = "down_steps.0.batch1.running_mean" in sd

    def get_block(prefix: str, p: Dict, s: Dict):
        for j, (conv, bn) in enumerate(_PAIRS):
            p[f"ConvBNRelu_{j}"] = {
                "kernel": _conv_to_jax(sd[f"{prefix}.{conv}.weight"]),
                "bias": _np(sd[f"{prefix}.{conv}.bias"]),
                "BatchNorm_0": {
                    "scale": _np(sd[f"{prefix}.{bn}.weight"]),
                    "bias": _np(sd[f"{prefix}.{bn}.bias"]),
                },
            }
            if with_stats:
                s[f"ConvBNRelu_{j}"] = {
                    "BatchNorm_0": {
                        "mean": _np(sd[f"{prefix}.{bn}.running_mean"]),
                        "var": _np(sd[f"{prefix}.{bn}.running_var"]),
                    }
                }

    for i in range(n):
        params[f"down{i}"], stats[f"down{i}"] = {}, {}
        get_block(f"down_steps.{i}", params[f"down{i}"], stats[f"down{i}"])
    for i in range(n - 1):
        params[f"up{i}"] = {
            "up_kernel": _tconv_to_jax(sd[f"up_steps.{i}.up_conv.weight"]),
            "up_bias": _np(sd[f"up_steps.{i}.up_conv.bias"]),
        }
        stats[f"up{i}"] = {}
        get_block(f"up_steps.{i}", params[f"up{i}"], stats[f"up{i}"])
    params["out_kernel"] = _conv_to_jax(sd["out_conv.weight"])
    params["out_bias"] = _np(sd["out_conv.bias"])
    if not with_stats:
        return {"params": params}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------


def optax_adam_state_from_torch(
    optimizer: torch.optim.Optimizer,
    model: torch.nn.Module,
    config: UNetConfig,
    weight_decay: float = 0.0,
    schedule_count: int | None = None,
) -> Dict:
    """The state dict (flax ``serialization.to_state_dict`` form, numpy
    leaves) of the optax Adam/AdamW chain that matches ``optimizer``, a
    ``torch.optim.Adam``/``AdamW`` over ``model.parameters()`` in one group:
    ``{"0": {"count", "mu", "nu"}, ...}`` with the moments in the JAX
    parameter tree's layout.  ``schedule_count``: the learning-rate
    schedule's step count, None for a constant rate.

    The chain is that of ``hcunet_tpu/train/trainer.py::_make_tx``:
    ``optax.adam`` is ``(ScaleByAdamState, <lr>)`` and ``optax.adamw``
    ``(ScaleByAdamState, EmptyState(), <lr>)``, where ``<lr>`` is
    ``ScaleByScheduleState(count)`` under a schedule and ``EmptyState()``
    (an empty dict) for a constant rate."""
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    state = optimizer.state
    mu, nu, steps = {}, {}, set()
    for name in names:
        st = state.get(params[name], {})
        zero = torch.zeros_like(params[name])
        mu[name] = st.get("exp_avg", zero)
        nu[name] = st.get("exp_avg_sq", zero)
        steps.add(int(st["step"]) if "step" in st else 0)
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam steps {sorted(steps)}")
    count = np.asarray(steps.pop(), np.int32)
    last = 2 if weight_decay else 1
    out = {
        "0": {
            "count": count,
            "mu": jax_variables_from_unet_state_dict(mu, config)["params"],
            "nu": jax_variables_from_unet_state_dict(nu, config)["params"],
        }
    }
    for i in range(1, last + 1):
        out[str(i)] = {}
    if schedule_count is not None:
        out[str(last)] = {"count": np.asarray(schedule_count, np.int32)}
    return out


def torch_adam_state_from_optax(
    opt_state: Mapping,
    optimizer: torch.optim.Optimizer,
    model: torch.nn.Module,
    config: UNetConfig,
) -> Tuple[Dict, int | None]:
    """Inverse of :func:`optax_adam_state_from_torch`: a state dict that
    ``optimizer.load_state_dict`` takes (its param groups kept), and the
    schedule's step count (None when the chain has no schedule state).
    ``opt_state``: the optax chain's state in state-dict form, as
    ``msgpack_restore`` returns it."""
    adam = opt_state["0"]
    count = int(np.asarray(adam["count"]))
    mu = unet_state_dict_from_jax_variables({"params": adam["mu"]}, config)
    nu = unet_state_dict_from_jax_variables({"params": adam["nu"]}, config)
    sd = optimizer.state_dict()
    state = {}
    if count:
        for i, name in enumerate(n for n, _ in model.named_parameters()):
            state[i] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name],
                "exp_avg_sq": nu[name],
            }
    sched = opt_state[str(len(opt_state) - 1)]
    schedule_count = int(np.asarray(sched["count"])) if "count" in sched else None
    return {"state": state, "param_groups": sd["param_groups"]}, schedule_count


# ---------------------------------------------------------------------------
# detector
# ---------------------------------------------------------------------------


def _put_bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _put_conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _conv_to_torch(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_linear(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def detector_state_dict_from_jax_variables(
    variables: Mapping, backbone: str = "resnet50", fpn_channels: int = 256
) -> Dict[str, torch.Tensor]:
    """State dict of :class:`hcunet_tpu_torch.models.detection.Detector`
    (torchvision's ``fasterrcnn_resnet50_fpn`` names) from the JAX
    ``Detector``'s ``{"trunk", "head"}`` variable tree, for the ``resnet50``
    backbone at any width and for ``small``.

    ``fc6`` is permuted from the JAX (H, W, C) flattening of the RoI
    features to torchvision's (C, H, W)."""
    tp, ts = variables["trunk"]["params"], variables["trunk"]["batch_stats"]
    body_p, body_s = tp["body"], ts["body"]
    sd: Dict[str, torch.Tensor] = {}
    body = "backbone.body"
    if backbone == "resnet50":
        _put_conv(sd, f"{body}.conv1", body_p["stem_conv"])
        _put_bn(sd, f"{body}.bn1", body_p["stem_bn"], body_s["stem_bn"])
        blocks = sorted(
            (k for k in body_p if k.startswith("stage")),
            key=lambda k: tuple(int(v) for v in k[5:].split("_block")),
        )
        for name in blocks:
            stage, b = (int(v) for v in name[5:].split("_block"))
            t = f"{body}.layer{stage - 1}.{b}"
            bp, bs = body_p[name], body_s[name]
            for i in range(3):
                _put_conv(sd, f"{t}.conv{i + 1}", bp[f"Conv_{i}"])
                _put_bn(sd, f"{t}.bn{i + 1}", bp[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"])
            if "downsample_conv" in bp:
                _put_conv(sd, f"{t}.downsample.0", bp["downsample_conv"])
                _put_bn(sd, f"{t}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
    elif backbone == "small":
        for i in range(4):
            _put_conv(sd, f"{body}.conv{i}_0", body_p[f"Conv_{2 * i}"])
            _put_bn(sd, f"{body}.bn{i}", body_p[f"BatchNorm_{i}"], body_s[f"BatchNorm_{i}"])
            _put_conv(sd, f"{body}.conv{i}_1", body_p[f"Conv_{2 * i + 1}"])
    else:
        raise ValueError(f"unknown backbone {backbone}")

    for i, lvl in enumerate(("c2", "c3", "c4", "c5")):
        _put_conv(sd, f"backbone.fpn.inner_blocks.{i}.0", tp["fpn"][f"lateral_{lvl}"])
    for i, lvl in enumerate(("p2", "p3", "p4", "p5")):
        _put_conv(sd, f"backbone.fpn.layer_blocks.{i}.0", tp["fpn"][f"output_{lvl}"])
    rpn = tp["rpn_head"]
    _put_conv(sd, "rpn.head.conv.0.0", rpn["conv"])
    _put_conv(sd, "rpn.head.cls_logits", rpn["cls_logits"])
    _put_conv(sd, "rpn.head.bbox_pred", rpn["bbox_pred"])

    head = variables["head"]["params"]["box_head"]
    fc6 = np.asarray(head["fc6"]["kernel"])  # [h*w*c, out], (h, w, c) order
    k = int(round((fc6.shape[0] / fpn_channels) ** 0.5))
    fc6 = fc6.T.reshape(-1, k, k, fpn_channels).transpose(0, 3, 1, 2)
    sd["roi_heads.box_head.fc6.weight"] = _t(fc6.reshape(fc6.shape[0], -1))
    sd["roi_heads.box_head.fc6.bias"] = _t(head["fc6"]["bias"])
    _put_linear(sd, "roi_heads.box_head.fc7", head["fc7"])
    _put_linear(sd, "roi_heads.box_predictor.cls_score", head["cls_score"])
    _put_linear(sd, "roi_heads.box_predictor.bbox_pred", head["bbox_pred"])
    return sd
