"""``hcat.validate.render_size``: paint cells into three classes by voxel
count and save ``size_validation.tif``."""

from hcunet_tpu_torch.analysis.export import render_size  # noqa: F401

__all__ = ["render_size"]
