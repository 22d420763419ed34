"""Serving wrapper: bind model and tile geometry once, segment many volumes
(twin of ``hcunet_tpu/infer/serving.py``, single device).

    seg = Segmenter(model, state_dict)            # on CUDA
    mask = seg.predict(volume)                    # [X, Y, Z, C] numpy in, numpy out

Volume shapes are bucketed to multiples of the tile core, as in the JAX
package, so every request of a bucket runs the same tile shapes.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hcunet_tpu_torch.config import (
    TileConfig,
    UNetConfig,
    auto_tile_config,
    device_hbm_bytes,
    resolve_device,
)
from hcunet_tpu_torch.models.unet import UNet
from hcunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class Segmenter:
    def __init__(
        self,
        model: UNet,
        weights: Optional[Mapping] = None,
        tile_cfg: Optional[TileConfig] = None,
        use_probability_map: bool = True,
        postprocess: Optional[Tuple[float, float, float]] = None,
        dtype: Optional[torch.dtype] = None,
        packed: bool = True,
        mesh=None,
        device=None,
    ):
        """``weights``: the port's (reference-named) state dict, or the JAX
        package's ``{"params", "batch_stats"}`` tree; ``None`` keeps the
        model's own.  ``packed`` selects the BN-folded serving forward
        (:func:`~hcunet_tpu_torch.infer.compile.compile_serving_apply`);
        otherwise the model's plain forward runs.  ``device`` is CUDA unless
        given."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device Segmenter (mesh=) is not ported yet"
            )
        self.device = resolve_device(device)
        self.cfg: UNetConfig = model.config
        dtype = dtype or model.dtype
        self.model = UNet(self.cfg, dtype=dtype)
        self.model.load_state_dict(model.state_dict())
        if weights is not None:
            if "params" in weights:
                from hcunet_tpu_torch.utils.port_jax import (
                    unet_state_dict_from_jax_variables,
                )

                weights = unet_state_dict_from_jax_variables(weights, self.cfg)
            self.model.load_state_dict(weights)
        self.model.to(self.device).eval()
        self.tile_cfg = tile_cfg or auto_tile_config(
            self.cfg, hbm_bytes=device_hbm_bytes(self.device)
        )
        self.use_probability_map = use_probability_map
        self.postprocess = postprocess
        if packed:
            from hcunet_tpu_torch.infer.compile import compile_serving_apply

            self.apply_fn = compile_serving_apply(
                self.model, dtype=dtype, device=self.device
            )
        else:
            self.apply_fn = self.model

    @classmethod
    def from_checkpoint(cls, path: str, dtype=None, **kwargs) -> "Segmenter":
        raise NotImplementedError(
            "the checkpoint format is not ported yet; build the UNet and pass "
            "its weights to Segmenter"
        )

    # -- shape bucketing ------------------------------------------------------

    def bucket_shape(self, spatial: Sequence[int]) -> Tuple[int, ...]:
        """Round a volume shape up to the tile-core grid so distinct inputs
        share tile shapes."""
        ev = self.tile_cfg.eval_size
        return tuple(
            int(-(-s // e) * e) if s > e else int(s) for s, e in zip(spatial, ev)
        )

    def predict(self, volume: np.ndarray) -> np.ndarray:
        """``volume``: [X, Y, Z, C] (already normalized).  Returns
        [X, Y, Z] float probabilities (or uint8 mask)."""
        from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask

        if volume.ndim != 4:
            raise ValueError(f"expected [X, Y, Z, C], got {volume.shape}")
        spatial = volume.shape[:-1]
        bucket = self.bucket_shape(spatial)
        if bucket != tuple(spatial):
            widths = [(0, b - s) for s, b in zip(spatial, bucket)] + [(0, 0)]
            volume = np.pad(volume, widths, mode="symmetric" if all(
                b - s <= s for s, b in zip(spatial, bucket)
            ) else "edge")
            log.info("bucketed %s -> %s", tuple(spatial), bucket)

        out = predict_segmentation_mask(
            self.apply_fn,
            np.asarray(volume[None], np.float32),
            self.cfg,
            self.tile_cfg,
            use_probability_map=self.use_probability_map,
            postprocess=self.postprocess,
            device=self.device,
        )
        out = out[0, ..., 0].cpu().numpy()
        return out[: spatial[0], : spatial[1], : spatial[2]]

    def warmup(self, shapes: Sequence[Sequence[int]]) -> None:
        """Run one request of each expected volume shape, so that the kernels
        are built and the allocator is warm before real traffic."""
        for sp in shapes:
            c = self.cfg.in_channels
            self.predict(np.zeros((*self.bucket_shape(sp), c), np.float32))
            log.info("warmed %s", tuple(sp))
