"""``hcat.haircell``: the per-cell domain object, as the study-level
validation driver imports it (``from hcat import haircell``).
"""

from hcunet_tpu_torch.analysis.haircell import HairCell  # noqa: F401

__all__ = ["HairCell"]
