"""Carry U-Net weights between the JAX package's variable tree and the port.

The JAX package keeps ``{"params", "batch_stats"}`` trees
(``hcunet_tpu/models/unet.py``); the port keeps the reference
``Unet_Constructor`` state dict.  These are the port's own copy of the
layout rules of ``hcunet_tpu/utils/port_torch.py``, on numpy arrays:

* conv weight: JAX ``[*k, Cin/g, Cout]`` ↔ torch ``[Cout, Cin/g, *k]``;
* transpose-conv weight: JAX ``[*k, Cin, Cout]`` ↔ torch ``[Cin, Cout, *k]``;
* BatchNorm ``scale/bias/mean/var`` ↔ ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    ``{"params", "batch_stats"}`` tree (numpy or array-like leaves)."""
    params, stats = variables["params"], variables["batch_stats"]
    n = len(config.feature_sizes)
    sd: Dict[str, torch.Tensor] = {}

    def put_block(prefix: str, p: Mapping, s: Mapping):
        for j, (conv, bn) in enumerate(_PAIRS):
            pj, sj = p[f"ConvBNRelu_{j}"], s[f"ConvBNRelu_{j}"]
            sd[f"{prefix}.{conv}.weight"] = _conv_to_torch(pj["kernel"])
            sd[f"{prefix}.{conv}.bias"] = _t(pj["bias"])
            sd[f"{prefix}.{bn}.weight"] = _t(pj["BatchNorm_0"]["scale"])
            sd[f"{prefix}.{bn}.bias"] = _t(pj["BatchNorm_0"]["bias"])
            sd[f"{prefix}.{bn}.running_mean"] = _t(sj["BatchNorm_0"]["mean"])
            sd[f"{prefix}.{bn}.running_var"] = _t(sj["BatchNorm_0"]["var"])
            sd[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(0)

    for i in range(n):
        put_block(f"down_steps.{i}", params[f"down{i}"], stats[f"down{i}"])
    for i in range(n - 1):
        p = params[f"up{i}"]
        sd[f"up_steps.{i}.up_conv.weight"] = _tconv_to_torch(p["up_kernel"])
        sd[f"up_steps.{i}.up_conv.bias"] = _t(p["up_bias"])
        put_block(f"up_steps.{i}", p, stats[f"up{i}"])
    sd["out_conv.weight"] = _conv_to_torch(params["out_kernel"])
    sd["out_conv.bias"] = _t(params["out_bias"])
    return sd


def jax_variables_from_unet_state_dict(sd: Mapping, config: UNetConfig) -> Dict:
    """Inverse of :func:`unet_state_dict_from_jax_variables`: the JAX
    ``{"params", "batch_stats"}`` tree, as numpy arrays, from the port's
    (or the reference's) state dict."""
    n = len(config.feature_sizes)
    params: Dict = {}
    stats: Dict = {}

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
    return {"params": params, "batch_stats": stats}
