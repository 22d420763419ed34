"""``hcat.validate``: QA artifacts."""

from hcunet_tpu_torch.hcat.validate.render_size import render_size  # noqa: F401

__all__ = ["render_size"]
