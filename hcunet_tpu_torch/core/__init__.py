from hcunet_tpu_torch.core.shapes import (
    calculate_indexes,
    conv_output_shape,
    conv_transpose_output_shape,
    crop_to,
    pool_output_shape,
    regular_tile_grid,
    unet_output_shape,
    unet_shrinkage,
)
from hcunet_tpu_torch.core.padding import reflection_pad, reflection_pad_np, pad_to_shape

__all__ = [
    "calculate_indexes",
    "conv_output_shape",
    "conv_transpose_output_shape",
    "crop_to",
    "pool_output_shape",
    "regular_tile_grid",
    "unet_output_shape",
    "unet_shrinkage",
    "reflection_pad",
    "reflection_pad_np",
    "pad_to_shape",
]
