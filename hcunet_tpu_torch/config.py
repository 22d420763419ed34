"""Typed configuration for the PyTorch port (twin of ``hcunet_tpu/config.py``).

The port keeps its own copy of the dataclasses it needs, so that importing it
never loads the JAX package.  ``device_hbm_bytes`` reads the CUDA card's
memory instead of a TPU's, and :func:`resolve_device` is the one place that
turns a caller's ``device`` argument into a ``torch.device``: CUDA unless the
caller names another device, and an error when CUDA is absent.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UNetConfig:
    """Architecture of the valid-conv U-Net (reference ``hcat/unet.py:15-123``).

    ``kernel1``/``kernel2`` mirror the reference's ``{'conv1':…, 'conv2':…}``
    per-step kernel dicts.  ``reference_skip_bug`` reproduces the reference's
    ``y = crop(x, y)`` behavior (``unet.py:313``) which replaces the skip
    connection with a copy of the upsampled tensor.
    """

    image_dimensions: int = 3
    in_channels: int = 4
    out_channels: int = 1
    feature_sizes: Tuple[int, ...] = (16, 32, 64, 128)
    kernel1: Tuple[int, ...] = (3, 3, 2)
    kernel2: Tuple[int, ...] = (3, 3, 1)
    upsample_kernel: Tuple[int, ...] = (8, 8, 2)
    max_pool_kernel: Tuple[int, ...] = (2, 2, 1)
    upsample_stride: Tuple[int, ...] = (2, 2, 1)
    dilation: int = 1
    groups: int = 2
    reference_skip_bug: bool = False

    def __post_init__(self):
        if self.image_dimensions not in (2, 3):
            raise ValueError(
                f"does not support {self.image_dimensions} dimensional images"
            )
        if len(self.feature_sizes) < 2:
            raise ValueError(
                f"the number of features must be at least 2, "
                f"not {len(self.feature_sizes)}"
            )
        for a, b in zip(self.feature_sizes[:-1], self.feature_sizes[1:]):
            if a * 2 != b:
                raise ValueError(
                    f"feature sizes must be multiples of two from each other: "
                    f"{a}*2 != {b}"
                )

    @classmethod
    def production_3d(cls) -> "UNetConfig":
        """The shipped inference architecture (``hcat/main.py:46-55``)."""
        return cls()

    @classmethod
    def readme_2d(cls) -> "UNetConfig":
        """The README quickstart config (``README.md:12-22``) — 2D."""
        return cls(
            image_dimensions=2,
            in_channels=4,
            out_channels=1,
            feature_sizes=(8, 16, 32, 64, 128),
            kernel1=(3, 3),
            kernel2=(3, 3),
            upsample_kernel=(2, 2),
            max_pool_kernel=(2, 2),
            upsample_stride=(2, 2),
            dilation=1,
            groups=1,
        )

    def shape_kwargs(self) -> Dict:
        """kwargs for :func:`hcunet_tpu_torch.core.shapes.unet_output_shape`."""
        return dict(
            n_levels=len(self.feature_sizes),
            kernel1=self.kernel1,
            kernel2=self.kernel2,
            pool=self.max_pool_kernel,
            up_kernel=self.upsample_kernel,
            up_stride=self.upsample_stride,
        )


@dataclass(frozen=True)
class RUNetConfig:
    """RecursiveUnet (``hcat/r_unet.py:38-160``): GRU-style recurrence over a
    2-level same-padding U-Net, fixed timesteps."""

    in_channels: int = 4
    out_channels: int = 5
    channels: Tuple[int, int, int] = (16, 32, 64)
    kernel: Tuple[int, int, int] = (3, 3, 3)
    upsample_kernel: Tuple[int, int, int] = (6, 6, 5)
    max_pool_kernel: Tuple[int, int, int] = (2, 2, 1)
    upsample_stride: Tuple[int, int, int] = (2, 2, 1)
    timesteps: int = 10


@dataclass(frozen=True)
class RDCNetConfig:
    """RDCNet (``hcat/r_unet.py:207-227``)."""

    in_channels: int = 4
    out_channels: int = 5
    complexity: int = 10
    timesteps: int = 10


@dataclass(frozen=True)
class DetectorConfig:
    """Faster R-CNN style detector (``hcat/rcnn.py:7-21`` contract)."""

    num_classes: int = 3
    max_detections: int = 500
    min_size: int = 256
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 512
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    roi_align_output: int = 7


# ---------------------------------------------------------------------------
# Inference configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TileConfig:
    """Tiled inference geometry.

    ``eval_size`` is the trusted output core per tile; ``pad`` the halo added
    on every face.  ``batch`` is how many tiles are evaluated per forward."""

    eval_size: Tuple[int, ...] = (300, 300, 10)
    pad: Tuple[int, ...] = (128, 128, 10)
    batch: int = 4
    reference_exact_grid: bool = False


@dataclass(frozen=True)
class WatershedConfig:
    """Instance segmentation constants (``hcat/__init__.py:18-30``).

    ``backend`` selects the per-tile implementation:

    * ``"fused"`` (default) — one native call per tile
      (``native/watershed.cpp:instance_tile3d``): virtual z-expansion,
      chamfer mask dilation, flood.
    * ``"materialized"`` — builds the z-expanded float64 volumes like the
      reference (``hcat/segment.py:444-450``) and floods them.
    * ``"device"`` — everything on the card
      (``ops/watershed_device.py`` bounded-iteration minimax-path
      relaxation, ``device_iters`` steps).  Approximate on plateau
      tie-breaks.
    """

    connectivity: int = 1
    compactness: float = 0.01
    expand_mask: int = 15
    expand_z: int = 5
    z_tolerance: int = 2
    mask_prob_threshold: float = 0.5
    cell_prob_threshold: float = 0.25
    seed_background_below: float = 0.15
    distance_floor: float = 0.2
    backend: str = "fused"
    device_iters: int = 96
    # host threads flooding tiles concurrently for the host backends (the
    # flood releases the GIL); write-backs stay in tile order, so the labels
    # are the same at any worker count.  0 = auto (cpu_count - 1, min 1).
    tile_workers: int = 0


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end ``analyze`` settings (``hcat/main.py:20-236``)."""

    numchunks: int = 3
    gaussian_sigma: float = 3.0
    prob_floor: float = 0.25
    prob_scale: float = 10.0
    normalize_mean: Tuple[float, ...] = (0.5, 0.5, 0.5, 0.5)
    normalize_std: Tuple[float, ...] = (0.5, 0.5, 0.5, 0.5)
    # dtype the probability map rides device→host in: "float32" (exact),
    # "bfloat16", or fixed point over the epilogue's static [0, prob_scale]
    # range, "uint16" (2 B/voxel, max abs error prob_scale/131070) or
    # "uint8" (1 B/voxel, max abs error prob_scale/510)
    prob_transfer_dtype: str = "float32"
    # zlib-compress the per-chunk spill files (lossless either way: disk
    # against CPU in the chunk tail and at reconstruct)
    spill_compress: bool = False
    detection_channels: Tuple[int, ...] = (0, 2, 3)
    unet: UNetConfig = field(default_factory=UNetConfig.production_3d)
    tiles: TileConfig = field(default_factory=TileConfig)
    watershed: WatershedConfig = field(default_factory=WatershedConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)


# ---------------------------------------------------------------------------
# (De)serialization: configs stored in checkpoints as JSON, in the JAX
# package's format (``hcunet_tpu/config.py:348,372``), so that a config.json
# written by either package loads in the other
# ---------------------------------------------------------------------------

_CONFIG_TYPES = {
    "UNetConfig": UNetConfig,
    "RUNetConfig": RUNetConfig,
    "RDCNetConfig": RDCNetConfig,
    "DetectorConfig": DetectorConfig,
    "TileConfig": TileConfig,
    "WatershedConfig": WatershedConfig,
    "PipelineConfig": PipelineConfig,
}


def config_to_dict(cfg) -> Dict:
    """A config as a JSON-ready dict, tagged with its type's name."""
    d = dataclasses.asdict(cfg)
    d["__type__"] = type(cfg).__name__
    return d


def _config_type(name: str):
    if name not in _CONFIG_TYPES:
        raise ValueError(f"unknown config type {name!r}")
    return _CONFIG_TYPES[name]


def _rebuild(cls, d: Dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict):
            v = _rebuild(_config_type(v.get("__type__", f.type.replace('"', ""))), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(d: Dict):
    """Inverse of :func:`config_to_dict`."""
    if "__type__" not in d:
        raise ValueError("missing __type__ tag")
    d = json.loads(json.dumps(d))  # a deep copy; lists become tuples below
    return _rebuild(_config_type(d["__type__"]), d)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_hbm_bytes(device=None) -> Optional[int]:
    """Total memory of a CUDA device, or None for any other device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def auto_tile_config(
    unet: UNetConfig,
    hbm_bytes: Optional[int] = None,
    z_extent: int = 15,
    bytes_per_elem: int = 2,  # bf16 inference
) -> TileConfig:
    """Pick tile geometry from the network's shrink and available memory.

    * the halo is the measured valid-conv shrink of the architecture
      (rounded up to a multiple of 8);
    * the tile side and batch are chosen so the first-level activation
      footprint fits half of device memory, preferring more tiles per
      forward over bigger tiles.
    """
    from hcunet_tpu_torch.core.shapes import unet_shrinkage

    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes() or 16 * 2**30
    budget = int(hbm_bytes * 0.5)

    tz = min(z_extent, 15)

    def shrink_at(side: int, pad_xy: int, pad_z: int):
        probe = (side + 2 * pad_xy, side + 2 * pad_xy)
        if unet.image_dimensions == 3:
            probe = probe + (tz + 2 * pad_z,)
        try:
            return unet_shrinkage(probe, **unet.shape_kwargs())
        except ValueError:
            return (64, 64, 8)

    # shrink depends (mildly) on the input size via pooling floors — iterate
    # to a fixed point at a representative tile side.
    pad_xy, pad_z = 48, 4 if unet.image_dimensions == 3 else 0
    for _ in range(3):
        s = shrink_at(512, pad_xy, pad_z)
        new_xy = -(-max(s[0], s[1]) // 8) * 8
        new_z = s[2] if unet.image_dimensions == 3 else 0
        if (new_xy, new_z) == (pad_xy, pad_z):
            break
        pad_xy, pad_z = new_xy, new_z

    best = TileConfig(
        eval_size=(128, 128, tz), pad=(pad_xy, pad_xy, pad_z), batch=1
    )
    c1 = unet.feature_sizes[0]
    # side capped at 384 and batch at 6, as in the JAX package, so both
    # packages tile a volume the same way
    for side in (256, 384):
        in_side = side + 2 * pad_xy
        in_z = tz + 2 * pad_z
        # ~4 first-level-sized tensors alive per tile through the pipeline
        per_tile = in_side * in_side * in_z * c1 * bytes_per_elem * 4
        batch = min(6, max(1, budget // max(per_tile, 1)))
        if per_tile <= budget:
            best = TileConfig(
                eval_size=(side, side, tz),
                pad=(pad_xy, pad_xy, pad_z),
                batch=int(batch),
            )
    return best
