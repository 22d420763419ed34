"""Backbone pretraining (twin of ``hcunet_tpu/train/pretrain.py``): the
detector's substitute for ImageNet weights.

The ResNet trunk (the detector's ``backbone.body``) plus a linear probe
learns a procedurally generated shape classification task (discs, rings,
squares, stripe gratings at random scales and intensities on noisy
backgrounds), which pushes the early filters toward edges and blobs.  The
images are the JAX package's, draw for draw from the same seed.  The
trained trunk comes back as the JAX body's ``{"params", "batch_stats"}``
tree, is saved in flax's msgpack bytes (:func:`save_backbone`, through the
port's ``utils/_flax_msgpack.py``), and seeds a detector's variables
(:func:`seed_detector_backbone`).
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hcunet_tpu_torch.config import resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.models.resnet import ResNet

N_CLASSES = 4  # disc, ring, square, stripes


def synthetic_shapes_batch(
    rng: np.random.Generator, n: int, hw: Tuple[int, int] = (64, 64)
) -> Tuple[np.ndarray, np.ndarray]:
    """Images [n, H, W, 3] float in [0,1]; labels [n] in 0..3."""
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    images = rng.normal(0.3, 0.08, (n, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, n)
    for i in range(n):
        cy, cx = rng.uniform(H * 0.3, H * 0.7), rng.uniform(W * 0.3, W * 0.7)
        r = rng.uniform(6, min(H, W) * 0.3)
        amp = rng.uniform(0.4, 0.7)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        if labels[i] == 0:  # disc
            m = (d < r).astype(np.float32)
        elif labels[i] == 1:  # ring
            m = ((d < r) & (d > r * 0.6)).astype(np.float32)
        elif labels[i] == 2:  # square
            m = (
                (np.abs(yy - cy) < r * 0.8) & (np.abs(xx - cx) < r * 0.8)
            ).astype(np.float32)
        else:  # stripes
            theta = rng.uniform(0, np.pi)
            period = rng.uniform(4, 12)
            phase = (xx * np.cos(theta) + yy * np.sin(theta)) / period
            m = ((np.sin(2 * np.pi * phase) > 0) & (d < r * 1.4)).astype(
                np.float32
            )
        chan = rng.dirichlet(np.ones(3)) * 3.0
        images[i] += (m * amp)[..., None] * chan[None, None, :].astype(np.float32)
    return images.clip(0, 1), labels.astype(np.int32)


class Classifier(nn.Module):
    """The ResNet trunk (``body``) and a linear probe on its mean-pooled
    ``c5``: the JAX function's ``Classifier``."""

    def __init__(self, width: int = 64):
        super().__init__()
        self.body = ResNet(width=width)
        self.probe = nn.Linear(self.body.out_channels[-1], N_CLASSES)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``images`` ``[B, H, W, 3]`` channels-last -> logits ``[B, 4]``."""
        feats = self.body(images.permute(0, 3, 1, 2))
        return self.probe(feats["c5"].mean(dim=(2, 3)))


def classifier_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """:class:`Classifier`'s state dict from the JAX classifier's
    ``{"params": {"body", "probe"}, "batch_stats": {"body"}}`` tree."""
    from hcunet_tpu_torch.utils.port_jax import backbone_state_dict_from_jax

    sd = backbone_state_dict_from_jax(
        {"params": variables["params"]["body"], "batch_stats": variables["batch_stats"]["body"]},
        "resnet50", prefix="body",
    )
    probe = variables["params"]["probe"]
    sd["probe.weight"] = torch.as_tensor(np.array(probe["kernel"], np.float32).T.copy())
    sd["probe.bias"] = torch.as_tensor(np.array(probe["bias"], np.float32))
    return sd


@exact_float32()
def pretrain_backbone(
    steps: int = 200,
    batch: int = 16,
    lr: float = 1e-3,
    width: int = 64,
    hw: Tuple[int, int] = (64, 64),
    seed: int = 0,
    log_every: int = 50,
    progress=print,
    device=None,
    init_variables: Optional[Mapping] = None,
) -> Dict:
    """Train a ResNet trunk on the synthetic shape task with Adam and
    train-mode batch norm; returns the trunk body's JAX variables
    (``params`` + ``batch_stats``, numpy) ready for
    :func:`seed_detector_backbone`.  Runs on ``device`` (CUDA unless
    given).  The weights start from flax's initializers' distributions
    (LeCun-normal kernels, the zero-init last BN) drawn from ``seed``, or
    from ``init_variables``, the JAX classifier's
    ``{"params": {"body", "probe"}, "batch_stats": {"body"}}`` tree."""
    from hcunet_tpu_torch.models.unet import init_like_flax
    from hcunet_tpu_torch.utils.port_jax import jax_backbone_from_state_dict

    dev = resolve_device(device)
    model = Classifier(width)
    if init_variables is not None:
        model.load_state_dict(classifier_state_dict_from_jax(init_variables))
    else:
        init_like_flax(model, torch.Generator().manual_seed(seed), scale=1.0)
    model.to(dev).train()
    rng = np.random.default_rng(seed)
    synthetic_shapes_batch(rng, 2, hw)  # the JAX function's init batch: the same draws
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for i in range(steps):
        images, labels = synthetic_shapes_batch(rng, batch, hw)
        images = torch.from_numpy(images).to(dev)
        labels = torch.from_numpy(labels).long().to(dev)
        logits = model(images)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, labels[:, None]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            acc = (logits.argmax(-1) == labels).float().mean()
            progress(
                f"pretrain step {i + 1}/{steps}: loss {float(loss.detach()):.3f} "
                f"acc {float(acc):.2f}"
            )
    return jax_backbone_from_state_dict(model.state_dict(), "resnet50", prefix="body")


def save_backbone(path: str, backbone_variables: Mapping) -> None:
    """Write the body's tree as flax's ``serialization.to_bytes`` does."""
    from hcunet_tpu_torch.utils._flax_msgpack import to_bytes

    with open(path, "wb") as f:
        f.write(to_bytes(backbone_variables))


def load_backbone(path: str, template: Optional[Mapping] = None) -> Dict:
    """Read a file of :func:`save_backbone` (or the JAX package's); with a
    ``template``, the tree must match it key for key and shape for shape."""
    from hcunet_tpu_torch.utils._flax_msgpack import msgpack_restore
    from hcunet_tpu_torch.utils.checkpoint import _check_like

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if template is not None:
        _check_like(template, tree, "backbone")
    return tree


def seed_detector_backbone(detector_variables: Mapping, backbone: Mapping) -> Dict:
    """Return detector variables (the JAX ``{"trunk", "head"}`` tree) whose
    trunk body is replaced by the pretrained backbone (shapes must match;
    everything else unchanged)."""
    out = copy.deepcopy(dict(detector_variables))
    tgt_p = out["trunk"]["params"]["body"]
    tgt_s = out["trunk"]["batch_stats"]["body"]

    def check(a, b, path):
        if isinstance(b, Mapping):
            if not isinstance(a, Mapping) or set(a) != set(b):
                raise ValueError(f"backbone tree mismatch at {path}")
            for k in b:
                check(a[k], b[k], f"{path}/{k}")
        elif np.shape(a) != np.shape(b):
            raise ValueError(
                f"backbone shape mismatch at {path}: {np.shape(a)} vs {np.shape(b)}"
            )

    check(backbone["params"], tgt_p, "params")
    check(backbone["batch_stats"], tgt_s, "batch_stats")
    out["trunk"]["params"]["body"] = copy.deepcopy(dict(backbone["params"]))
    out["trunk"]["batch_stats"]["body"] = copy.deepcopy(dict(backbone["batch_stats"]))
    return out
