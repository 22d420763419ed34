"""PyTorch and CUDA port of ``hcunet_tpu`` for NVIDIA Hopper GPUs.

Each module mirrors the JAX package's module of the same path and keeps its
public names and layouts (channels-last ``[B, X, Y, Z, C]``, numpy at the
host boundary).  The JAX package stays the reference; the port imports
neither it nor JAX.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from hcunet_tpu_torch.config import (
    DetectorConfig,
    PipelineConfig,
    TileConfig,
    UNetConfig,
    WatershedConfig,
    auto_tile_config,
)
from hcunet_tpu_torch.infer.pipeline import AnalyzeResult, analyze

__all__ = [
    "AnalyzeResult", "DetectorConfig", "PipelineConfig", "TileConfig", "UNetConfig",
    "WatershedConfig", "__version__", "analyze", "auto_tile_config",
]
