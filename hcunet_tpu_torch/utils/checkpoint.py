"""Checkpoints in the JAX package's zip format (twin of
``hcunet_tpu/utils/checkpoint.py``).

A checkpoint is a zip:

    variables.msgpack    the JAX-named variables (params + batch_stats),
                         flax-serialized (``utils/_flax_msgpack.py``)
    config.json          the model's dataclass config (rebuildable)
    hyperparameters.json optional training hyperparameters
    manifest.json        the port's version, tree listing
    sources/...          snapshot of the port's .py files

So a checkpoint written by either package loads in the other.
:func:`load_unet` and :func:`load_model` rebuild the architecture from
config.json before restoring the weights, as the reference's ``load`` does
(``hcat/unet.py:167-196``).
"""

from __future__ import annotations

import glob
import json
import os
import zipfile
from typing import Dict, Mapping, Optional

import numpy as np

import hcunet_tpu_torch
from hcunet_tpu_torch.config import DetectorConfig, UNetConfig, config_from_dict, config_to_dict
from hcunet_tpu_torch.utils._flax_msgpack import msgpack_restore, to_bytes

CKPT_SOURCES_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def save_checkpoint(
    path: str,
    variables: Mapping,
    config,
    hyperparameters: Optional[Dict] = None,
    snapshot_sources: bool = True,
) -> None:
    """``variables``: the JAX-named tree with numpy leaves (for a UNet,
    ``jax_variables_from_unet_state_dict`` of its state dict)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("variables.msgpack", to_bytes(variables))
        z.writestr("config.json", json.dumps(config_to_dict(config)))
        z.writestr("hyperparameters.json", json.dumps(hyperparameters or {}))
        tree = sorted(
            os.path.relpath(p, CKPT_SOURCES_ROOT)
            for p in glob.glob(os.path.join(CKPT_SOURCES_ROOT, "**", "*"), recursive=True)
        )
        z.writestr(
            "manifest.json",
            json.dumps({"version": hcunet_tpu_torch.__version__, "tree_structure": tree}),
        )
        if snapshot_sources:
            for p in glob.glob(os.path.join(CKPT_SOURCES_ROOT, "**", "*.py"), recursive=True):
                rel = os.path.relpath(p, CKPT_SOURCES_ROOT)
                with open(p, "r") as f:
                    z.writestr(f"sources/{rel}", f.read())


def _check_like(template, tree, path="variables") -> None:
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(template) != set(tree):
            raise ValueError(f"{path}: keys {sorted(tree) if isinstance(tree, Mapping) else tree!r} "
                             f"do not match the template's {sorted(template)}")
        for k in template:
            _check_like(template[k], tree[k], f"{path}/{k}")
    elif np.shape(template) != np.shape(tree):
        raise ValueError(f"{path}: shape {np.shape(tree)} != template's {np.shape(template)}")


def load_checkpoint(path: str, variables_template: Optional[Mapping] = None):
    """Returns ``(config, variables, hyperparameters)``, the variables as the
    nested dict of numpy arrays.  ``variables_template``: a tree the
    variables must match key for key and shape for shape."""
    with zipfile.ZipFile(path, "r") as z:
        config = config_from_dict(json.loads(z.read("config.json")))
        hyper = json.loads(z.read("hyperparameters.json"))
        raw = z.read("variables.msgpack")
    variables = msgpack_restore(raw)
    if variables_template is not None:
        _check_like(variables_template, variables)
    return config, variables, hyper


def _unet(config: UNetConfig, variables: Mapping):
    from hcunet_tpu_torch.models.unet import UNet
    from hcunet_tpu_torch.utils.port_jax import unet_state_dict_from_jax_variables

    model = UNet(config)
    model.load_state_dict(unet_state_dict_from_jax_variables(variables, config))
    return model.eval()


def load_unet(path: str):
    """Rebuild the UNet from its stored config and restore its weights (a
    float32 model on the CPU).  Returns ``(model, variables,
    hyperparameters)``."""
    config, variables, hyper = load_checkpoint(path)
    if not isinstance(config, UNetConfig):
        raise ValueError(f"{path} holds a {type(config).__name__}, not a UNetConfig")
    return _unet(config, variables), variables, hyper


def load_model(path: str, device=None):
    """Generic loader: rebuilds the model family of the stored config
    (UNet, on the CPU as :func:`load_unet` gives it; Detector, the
    ResNet50-FPN, on ``device``, CUDA unless given) with its weights.  The
    recurrent families (RUNetConfig, RDCNetConfig) are not ported yet and
    raise ``NotImplementedError``.

    Returns ``(model, variables, hyperparameters)``."""
    cfg, variables, hyper = load_checkpoint(path)
    if isinstance(cfg, UNetConfig):
        return _unet(cfg, variables), variables, hyper
    if isinstance(cfg, DetectorConfig):
        from hcunet_tpu_torch.models.detection import Detector
        from hcunet_tpu_torch.utils.port_jax import detector_state_dict_from_jax_variables

        det = Detector(cfg, device=device)
        det.load_state_dict(detector_state_dict_from_jax_variables(variables))
        return det, variables, hyper
    raise ValueError(f"no model family for config type {type(cfg).__name__}")
