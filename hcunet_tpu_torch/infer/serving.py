"""Serving wrapper: bind model and tile geometry once, segment many volumes
(twin of ``hcunet_tpu/infer/serving.py``).

    seg = Segmenter(model, state_dict)            # on CUDA
    mask = seg.predict(volume)                    # [X, Y, Z, C] numpy in, numpy out

Volume shapes are bucketed to multiples of the tile core, as in the JAX
package, so every request of a bucket runs the same tile shapes.  With a
``mesh`` (a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh` with a ``spatial``
axis), a volume wide enough is split along X over the ``spatial`` devices,
each running the tile engine on its slab with the forward built on its
device (:func:`~hcunet_tpu_torch.parallel.tiled.sharded_tiled_forward`).
"""

from __future__ import annotations

import warnings
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
from hcunet_tpu_torch.core.padding import pad_axes
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.infer.tiling import _as_image, predict_segmentation_mask
from hcunet_tpu_torch.models.unet import UNet
from hcunet_tpu_torch.utils.logging import get_logger
from hcunet_tpu_torch.utils.profiling import span

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
        given (with a ``mesh``, its first ``spatial`` device).

        ``mesh``: a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh` with a
        ``spatial`` axis.  ``predict`` then shards a volume's X axis over
        it, each shard running the tile engine on its device with halos
        copied from its neighbours, and volumes are bucket-padded so that
        every shard owns whole tile columns."""
        self.mesh = mesh
        self._n_shards = 1
        self._sharded_fn = None
        if mesh is not None:
            from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, require_mesh

            if SPATIAL_AXIS not in require_mesh(mesh).axis_names:
                raise ValueError(f"mesh {mesh.axis_names} has no '{SPATIAL_AXIS}' axis")
            self._n_shards = int(mesh.shape[SPATIAL_AXIS])
            if device is None:
                device = mesh.axis_devices(SPATIAL_AXIS)[0]
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
        self.packed = packed
        self.apply_fn = self._forward_on(self.device)

    def _forward_on(self, device):
        """The serving forward on ``device``: the BN-folded one
        (``packed``), else the model's own forward (a copy of the model
        off ``self.device``)."""
        if self.packed:
            from hcunet_tpu_torch.infer.compile import compile_serving_apply

            return compile_serving_apply(self.model, dtype=self.model.dtype, device=device)
        if torch.device(device) == self.device:
            return self.model
        import copy

        return copy.deepcopy(self.model).to(device)

    @classmethod
    def from_checkpoint(cls, path: str, dtype=None, **kwargs) -> "Segmenter":
        """A Segmenter on a checkpoint of either package
        (:func:`~hcunet_tpu_torch.utils.checkpoint.load_unet`)."""
        from hcunet_tpu_torch.utils.checkpoint import load_unet

        model, variables, _ = load_unet(path)
        return cls(model, variables, dtype=dtype, **kwargs)

    # -- shape bucketing ------------------------------------------------------

    def _use_sharded(self, spatial: Sequence[int]) -> bool:
        """Shard only when every shard holds at least one tile column of
        real data and the per-shard slab clears the halo constraint
        (``sharded_tiled_forward`` needs a slab of at least ``max(pad_x,
        eval_x)``); thinner volumes run the single-device engine."""
        if self._n_shards <= 1:
            return False
        ev_x = int(self.tile_cfg.eval_size[0])
        if spatial[0] < self._n_shards * ev_x:
            return False
        quantum = ev_x * self._n_shards
        bucket_x = -(-int(spatial[0]) // quantum) * quantum
        return bucket_x // self._n_shards >= max(int(self.tile_cfg.pad[0]), ev_x)

    def bucket_shape(self, spatial: Sequence[int]) -> Tuple[int, ...]:
        """Round a volume shape up to the tile-core grid so distinct inputs
        share tile shapes.  Sharded, X also rounds to whole tile columns per
        shard (``n_shards * eval_x``)."""
        ev = self.tile_cfg.eval_size
        bucket = [int(-(-s // e) * e) if s > e else int(s) for s, e in zip(spatial, ev)]
        if self._use_sharded(spatial):
            quantum = int(ev[0]) * self._n_shards
            bucket[0] = int(-(-spatial[0] // quantum) * quantum)
        return tuple(bucket)

    @exact_float32()
    def predict(self, volume: np.ndarray) -> np.ndarray:
        """``volume``: [X, Y, Z, C] (already normalized).  Returns
        [X, Y, Z] float probabilities (or uint8 mask).

        The volume goes to the device as given and is padded to its bucket
        there; the map is cropped back to the volume there too, so the
        padding never crosses the bus."""
        if volume.ndim != 4:
            raise ValueError(f"expected [X, Y, Z, C], got {volume.shape}")
        with span("hcunet.serve.predict"):
            spatial = tuple(volume.shape[:-1])
            bucket = self.bucket_shape(spatial)
            with span("hcunet.tiling.upload"), warnings.catch_warnings():
                # a read-only stack is only read (copied to the device), so
                # torch's warning on wrapping one says nothing here
                warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
                image = _as_image(volume[None], self.device)
            with span("hcunet.serve.bucket_pad"):
                if bucket != spatial:
                    # one mode for every axis (the JAX package's np.pad rule),
                    # not pad_to_shape's per-axis fallback
                    widths = [(0, b - s) for s, b in zip(spatial, bucket)]
                    symmetric = all(b - s <= s for s, b in zip(spatial, bucket))
                    image = pad_axes(image, widths, "symmetric" if symmetric else "edge")
                    log.info("bucketed %s -> %s", spatial, bucket)
            if self._use_sharded(spatial):
                out = self._sharded_forward()(image)
            else:
                out = predict_segmentation_mask(
                    self.apply_fn,
                    image,
                    self.cfg,
                    self.tile_cfg,
                    use_probability_map=self.use_probability_map,
                    postprocess=self.postprocess,
                    # the tensor's own device ("cuda:0", not "cuda"): there is
                    # nothing left to move, so no second upload span opens
                    device=image.device,
                )
            with span("hcunet.serve.readback"):
                return out[0, : spatial[0], : spatial[1], : spatial[2], 0].cpu().numpy()

    def _sharded_forward(self):
        """Build (once) the multi-device tiled forward for this mesh, with
        the forward built on each of its ``spatial`` devices."""
        if self._sharded_fn is None:
            from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, canonical_device
            from hcunet_tpu_torch.parallel.tiled import sharded_tiled_forward

            applies = {canonical_device(self.device): self.apply_fn}
            for d in self.mesh.axis_devices(SPATIAL_AXIS):
                if d not in applies:
                    applies[d] = self._forward_on(d)
            self._sharded_fn = sharded_tiled_forward(
                applies,
                self.mesh,
                self.cfg,
                self.tile_cfg,
                use_probability_map=self.use_probability_map,
                postprocess=self.postprocess,
            )
        return self._sharded_fn

    def warmup(self, shapes: Sequence[Sequence[int]]) -> None:
        """Run one request of each expected volume shape, so that the kernels
        are built and the allocator is warm before real traffic."""
        for sp in shapes:
            c = self.cfg.in_channels
            self.predict(np.zeros((*self.bucket_shape(sp), c), np.float32))
            log.info("warmed %s", tuple(sp))
