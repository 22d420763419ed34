"""``hcat.mask``: the chunk spill record, as the valscripts driver imports
it (``from hcat import mask as m``).

:class:`Part` is the port's chunk record: per-chunk semantic and instance
masks with a global top-left ``loc``, spilled as npz.  Build one with
``Part.create(mask, segmented_mask, loc)``; masks are ``[X, Y, Z]``.
"""

from hcunet_tpu_torch.infer.chunks import Part  # noqa: F401

__all__ = ["Part"]
