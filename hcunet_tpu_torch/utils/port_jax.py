"""Carry weights between the JAX package's variable trees and the port.

The JAX package keeps ``{"params", "batch_stats"}`` trees
(``hcunet_tpu/models/unet.py``, ``models/detection.py``, ``models/runet.py``,
``models/rdcnet.py``); the port keeps the
reference ``Unet_Constructor`` state dict and torchvision's
``fasterrcnn_resnet50_fpn`` names.  These are the port's own copy of the
layout rules of ``hcunet_tpu/utils/port_torch.py``, on numpy arrays:

* conv weight: JAX ``[*k, Cin/g, Cout]`` ↔ torch ``[Cout, Cin/g, *k]``;
* transpose-conv weight: JAX ``[*k, Cin, Cout]`` ↔ torch ``[Cin, Cout, *k]``;
* BatchNorm ``scale/bias/mean/var`` ↔ ``weight/bias/running_mean/running_var``.

The recurrent family (``RecursiveUNet``, ``RDCNet``) keeps the reference
``hcat/r_unet.py`` module names on the port's side, as
``runet_variables_from_torch_state_dict`` and
``rdcnet_variables_from_torch_state_dict`` of the JAX package read them.

Optax's Adam moments have their parameters' layouts, so the optimizer
state crosses with the same rules (:func:`torch_adam_state_from_optax`,
:func:`optax_adam_state_from_torch`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

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


def _put_convbn(sd: Dict, prefix: str, p: Mapping, s: Mapping | None, layer: str) -> None:
    """A block's two conv + BN pairs (``{layer}_0``/``{layer}_1`` in JAX)
    into ``sd`` under ``prefix.conv1/batch1/conv2/batch2``; the running
    statistics where ``s`` holds them."""
    for j, (conv, bn) in enumerate(_PAIRS):
        pj = p[f"{layer}_{j}"]
        sd[f"{prefix}.{conv}.weight"] = _conv_to_torch(pj["kernel"])
        sd[f"{prefix}.{conv}.bias"] = _t(pj["bias"])
        sd[f"{prefix}.{bn}.weight"] = _t(pj["BatchNorm_0"]["scale"])
        sd[f"{prefix}.{bn}.bias"] = _t(pj["BatchNorm_0"]["bias"])
        if s is None:
            continue
        sj = s[f"{layer}_{j}"]
        sd[f"{prefix}.{bn}.running_mean"] = _t(sj["BatchNorm_0"]["mean"])
        sd[f"{prefix}.{bn}.running_var"] = _t(sj["BatchNorm_0"]["var"])
        sd[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(0)


def _get_convbn(sd: Mapping, prefix: str, p: Dict, s: Dict, layer: str, with_stats: bool) -> None:
    """Inverse of :func:`_put_convbn`: fills the JAX trees ``p`` and ``s``."""
    for j, (conv, bn) in enumerate(_PAIRS):
        p[f"{layer}_{j}"] = {
            "kernel": _conv_to_jax(sd[f"{prefix}.{conv}.weight"]),
            "bias": _np(sd[f"{prefix}.{conv}.bias"]),
            "BatchNorm_0": {
                "scale": _np(sd[f"{prefix}.{bn}.weight"]),
                "bias": _np(sd[f"{prefix}.{bn}.bias"]),
            },
        }
        if with_stats:
            s[f"{layer}_{j}"] = {
                "BatchNorm_0": {
                    "mean": _np(sd[f"{prefix}.{bn}.running_mean"]),
                    "var": _np(sd[f"{prefix}.{bn}.running_var"]),
                }
            }


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
    for i in range(n):
        _put_convbn(sd, f"down_steps.{i}", params[f"down{i}"], stats and stats[f"down{i}"],
                    "ConvBNRelu")
    for i in range(n - 1):
        p = params[f"up{i}"]
        sd[f"up_steps.{i}.up_conv.weight"] = _tconv_to_torch(p["up_kernel"])
        sd[f"up_steps.{i}.up_conv.bias"] = _t(p["up_bias"])
        _put_convbn(sd, f"up_steps.{i}", p, stats and stats[f"up{i}"], "ConvBNRelu")
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
    for i in range(n):
        params[f"down{i}"], stats[f"down{i}"] = {}, {}
        _get_convbn(sd, f"down_steps.{i}", params[f"down{i}"], stats[f"down{i}"],
                    "ConvBNRelu", with_stats)
    for i in range(n - 1):
        params[f"up{i}"] = {
            "up_kernel": _tconv_to_jax(sd[f"up_steps.{i}.up_conv.weight"]),
            "up_bias": _np(sd[f"up_steps.{i}.up_conv.bias"]),
        }
        stats[f"up{i}"] = {}
        _get_convbn(sd, f"up_steps.{i}", params[f"up{i}"], stats[f"up{i}"],
                    "ConvBNRelu", with_stats)
    params["out_kernel"] = _conv_to_jax(sd["out_conv.weight"])
    params["out_bias"] = _np(sd["out_conv.bias"])
    if not with_stats:
        return {"params": params}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# recurrent family
# ---------------------------------------------------------------------------

# JAX scope of each RecursiveUNet block (under the scanned "step") -> the
# reference's module name (hcunet_tpu/utils/port_torch.py:186-205)
_RUNET_BLOCKS = (
    ("down1", "down1"),
    ("fh/down_a", "down2_fh"), ("fh/down_b", "down3_fh"), ("fh/up", "up1_fh"),
    ("fz/down_a", "down2_fz"), ("fz/down_b", "down3_fz"), ("fz/up", "up1_fz"),
    ("up2", "up2"),
)


def _scope(tree: Mapping, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def runet_state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`hcunet_tpu_torch.models.runet.RecursiveUNet`
    (the reference ``RecursiveUnet``'s names) from the JAX model's
    ``{"params", "batch_stats"}`` tree, whose blocks sit under the scanned
    ``step``; a tree without ``batch_stats`` (an optimizer moment) gives
    the parameters alone."""
    params = variables["params"]["step"]
    stats = variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    for scope, name in _RUNET_BLOCKS:
        p = _scope(params, scope)
        if "up_kernel" in p:
            sd[f"{name}.up_conv.weight"] = _tconv_to_torch(p["up_kernel"])
            sd[f"{name}.up_conv.bias"] = _t(p["up_bias"])
        _put_convbn(sd, name, p, stats and _scope(stats["step"], scope), "SameConvBNRelu")
    sd["out_conv.weight"] = _conv_to_torch(params["out_kernel"])
    sd["out_conv.bias"] = _t(params["out_bias"])
    return sd


def jax_variables_from_runet_state_dict(sd: Mapping) -> Dict:
    """Inverse of :func:`runet_state_dict_from_jax_variables`: the JAX
    ``{"params": {"step": ...}, "batch_stats": {"step": ...}}`` tree as
    numpy arrays (what the JAX package's
    ``runet_variables_from_torch_state_dict`` gives for the same dict);
    ``{"params"}`` alone where ``sd`` holds no running statistics."""
    with_stats = "down1.batch1.running_mean" in sd
    params: Dict = {"fh": {}, "fz": {}}
    stats: Dict = {"fh": {}, "fz": {}}
    for scope, name in _RUNET_BLOCKS:
        *parent, leaf = scope.split("/")
        p_parent = _scope(params, "/".join(parent)) if parent else params
        s_parent = _scope(stats, "/".join(parent)) if parent else stats
        p, s = {}, {}
        if f"{name}.up_conv.weight" in sd:
            p["up_kernel"] = _tconv_to_jax(sd[f"{name}.up_conv.weight"])
            p["up_bias"] = _np(sd[f"{name}.up_conv.bias"])
        _get_convbn(sd, name, p, s, "SameConvBNRelu", with_stats)
        p_parent[leaf], s_parent[leaf] = p, s
    params["out_kernel"] = _conv_to_jax(sd["out_conv.weight"])
    params["out_bias"] = _np(sd["out_conv.bias"])
    if not with_stats:
        return {"params": {"step": params}}
    return {"params": {"step": params}, "batch_stats": {"step": stats}}


# JAX name of each RDCNet conv -> the reference's module name
# (hcunet_tpu/utils/port_torch.py:208-285), (conv, transposed)
_RDCNET_CONVS = (
    (("in",), "strided_conv", False),
    (("step", "rdc_block", "squeeze"), "RDCblock.conv", False),
    *((("step", "rdc_block", "StackedDilation_0", f"conv{d}"), f"RDCblock.grouped_conv.conv{d}",
       False) for d in range(1, 6)),
    (("step", "rdc_block", "StackedDilation_0", "merge"), "RDCblock.grouped_conv.out_conv", False),
    (("out",), "out_conv", False),
    (("up",), "transposed_conv", True),
)


def rdcnet_state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`hcunet_tpu_torch.models.rdcnet.RDCNet` (the
    reference ``RDCNet``'s names) from the JAX model's ``{"params"}``
    tree."""
    sd: Dict[str, torch.Tensor] = {}
    for (*scope, leaf), name, transposed in _RDCNET_CONVS:
        p = _scope(variables["params"], "/".join(scope)) if scope else variables["params"]
        sd[f"{name}.weight"] = (_tconv_to_torch if transposed else _conv_to_torch)(
            p[f"{leaf}_kernel"]
        )
        sd[f"{name}.bias"] = _t(p[f"{leaf}_bias"])
    return sd


def jax_variables_from_rdcnet_state_dict(sd: Mapping) -> Dict:
    """Inverse of :func:`rdcnet_state_dict_from_jax_variables`: the JAX
    ``{"params"}`` tree as numpy arrays."""
    params: Dict = {}
    for (*scope, leaf), name, transposed in _RDCNET_CONVS:
        p = params
        for part in scope:
            p = p.setdefault(part, {})
        p[f"{leaf}_kernel"] = (_tconv_to_jax if transposed else _conv_to_jax)(sd[f"{name}.weight"])
        p[f"{leaf}_bias"] = _np(sd[f"{name}.bias"])
    return {"params": params}


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------


def optax_adam_state_from_torch(
    optimizer: torch.optim.Optimizer,
    model: torch.nn.Module,
    to_jax_params: Callable[[Mapping], Dict],
    weight_decay: float = 0.0,
    schedule_count: int | None = None,
) -> Dict:
    """The state dict (flax ``serialization.to_state_dict`` form, numpy
    leaves) of the optax Adam/AdamW chain that matches ``optimizer``, a
    ``torch.optim.Adam``/``AdamW`` over ``model.parameters()`` in one group:
    ``{"0": {"count", "mu", "nu"}, ...}`` with the moments in the JAX
    parameter tree's layout, which ``to_jax_params`` (a state dict of the
    model's parameters -> the JAX ``params`` tree) gives.
    ``schedule_count``: the learning-rate schedule's step count, None for a
    constant rate.

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
    out = {"0": {"count": count, "mu": to_jax_params(mu), "nu": to_jax_params(nu)}}
    for i in range(1, last + 1):
        out[str(i)] = {}
    if schedule_count is not None:
        out[str(last)] = {"count": np.asarray(schedule_count, np.int32)}
    return out


def torch_adam_state_from_optax(
    opt_state: Mapping,
    optimizer: torch.optim.Optimizer,
    model: torch.nn.Module,
    to_state_dict: Callable[[Mapping], Dict],
) -> Tuple[Dict, int | None]:
    """Inverse of :func:`optax_adam_state_from_torch`: a state dict that
    ``optimizer.load_state_dict`` takes (its param groups kept), and the
    schedule's step count (None when the chain has no schedule state).
    ``opt_state``: the optax chain's state in state-dict form, as
    ``msgpack_restore`` returns it; ``to_state_dict``: a JAX ``params``
    tree -> the model's state dict of those parameters."""
    adam = opt_state["0"]
    count = int(np.asarray(adam["count"]))
    mu = to_state_dict(adam["mu"])
    nu = to_state_dict(adam["nu"])
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


def backbone_state_dict_from_jax(
    backbone_variables: Mapping, backbone: str = "resnet50", prefix: str = "backbone.body"
) -> Dict[str, torch.Tensor]:
    """The trunk body's state dict (torchvision's ``resnet50`` names, or the
    small backbone's, under ``prefix``) from the JAX body's ``{"params",
    "batch_stats"}`` tree: the ``body`` scope of the JAX ``Detector``'s
    trunk, or what ``train/pretrain.py::pretrain_backbone`` returns."""
    body_p, body_s = backbone_variables["params"], backbone_variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    body = prefix
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
    return sd


def jax_backbone_from_state_dict(
    sd: Mapping, backbone: str = "resnet50", prefix: str = "backbone.body"
) -> Dict:
    """Inverse of :func:`backbone_state_dict_from_jax`: the JAX body's
    ``{"params", "batch_stats"}`` tree (numpy leaves) from the state dict
    entries under ``prefix``."""
    body_p: Dict = {}
    body_s: Dict = {}
    body = prefix
    if backbone == "resnet50":
        body_p["stem_conv"] = _conv_params(sd, f"{body}.conv1")
        body_p["stem_bn"], body_s["stem_bn"] = _bn_to_jax(sd, f"{body}.bn1")
        blocks = sorted({  # (stage, block) of every "<prefix>.layer<s>.<b>...."
            (int(k[len(body) + 1:].split(".")[0][5:]), int(k[len(body) + 1:].split(".")[1]))
            for k in sd if k.startswith(f"{body}.layer")
        })
        for stage, b in blocks:
            t = f"{body}.layer{stage}.{b}"
            name = f"stage{stage + 1}_block{b}"
            bp: Dict = {}
            bs: Dict = {}
            for i in range(3):
                bp[f"Conv_{i}"] = _conv_params(sd, f"{t}.conv{i + 1}")
                bp[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"] = _bn_to_jax(sd, f"{t}.bn{i + 1}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = _conv_params(sd, f"{t}.downsample.0")
                bp["downsample_bn"], bs["downsample_bn"] = _bn_to_jax(sd, f"{t}.downsample.1")
            body_p[name], body_s[name] = bp, bs
    elif backbone == "small":
        for i in range(4):
            body_p[f"Conv_{2 * i}"] = _conv_params(sd, f"{body}.conv{i}_0")
            body_p[f"BatchNorm_{i}"], body_s[f"BatchNorm_{i}"] = _bn_to_jax(sd, f"{body}.bn{i}")
            body_p[f"Conv_{2 * i + 1}"] = _conv_params(sd, f"{body}.conv{i}_1")
    else:
        raise ValueError(f"unknown backbone {backbone}")
    return {"params": body_p, "batch_stats": body_s}


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
    sd: Dict[str, torch.Tensor] = backbone_state_dict_from_jax(
        {"params": tp["body"], "batch_stats": ts["body"]}, backbone
    )
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


def _bn_to_jax(sd: Mapping, prefix: str) -> Tuple[Dict, Dict]:
    return (
        {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])},
        {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])},
    )


def _conv_params(sd: Mapping, prefix: str) -> Dict:
    p = {"kernel": _conv_to_jax(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _linear_params(sd: Mapping, prefix: str) -> Dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(), "bias": _np(sd[f"{prefix}.bias"])}


def jax_variables_from_detector_state_dict(
    sd: Mapping, backbone: str = "resnet50", fpn_channels: int = 256
) -> Dict:
    """The JAX ``Detector``'s ``{"trunk", "head"}`` variable tree (numpy
    leaves) from the port's detector state dict: the inverse of
    :func:`detector_state_dict_from_jax_variables`, so that a detector
    checkpoint written by the port loads in the JAX package."""
    body = jax_backbone_from_state_dict(sd, backbone)
    body_p, body_s = body["params"], body["batch_stats"]

    fpn = {}
    for i, lvl in enumerate(("c2", "c3", "c4", "c5")):
        fpn[f"lateral_{lvl}"] = _conv_params(sd, f"backbone.fpn.inner_blocks.{i}.0")
    for i, lvl in enumerate(("p2", "p3", "p4", "p5")):
        fpn[f"output_{lvl}"] = _conv_params(sd, f"backbone.fpn.layer_blocks.{i}.0")
    rpn = {
        "conv": _conv_params(sd, "rpn.head.conv.0.0"),
        "cls_logits": _conv_params(sd, "rpn.head.cls_logits"),
        "bbox_pred": _conv_params(sd, "rpn.head.bbox_pred"),
    }
    fc6 = _np(sd["roi_heads.box_head.fc6.weight"])  # [out, c*h*w], (c, h, w) order
    k = int(round((fc6.shape[1] / fpn_channels) ** 0.5))
    fc6 = fc6.reshape(-1, fpn_channels, k, k).transpose(0, 2, 3, 1).reshape(fc6.shape[0], -1)
    head = {
        "fc6": {"kernel": fc6.T.copy(), "bias": _np(sd["roi_heads.box_head.fc6.bias"])},
        "fc7": _linear_params(sd, "roi_heads.box_head.fc7"),
        "cls_score": _linear_params(sd, "roi_heads.box_predictor.cls_score"),
        "bbox_pred": _linear_params(sd, "roi_heads.box_predictor.bbox_pred"),
    }
    return {
        "trunk": {
            "params": {"body": body_p, "fpn": fpn, "rpn_head": rpn},
            "batch_stats": {"body": body_s},
        },
        "head": {"params": {"box_head": head}},
    }
