"""``hcat.dataloader``: the reference's datasets, as its R-CNN training
driver imports them (``from hcat import dataloader``).

:class:`Stack` loads ``X.tif``/``X.mask.tif``/``X.pwl.tif`` triplets,
:class:`Section` parses PASCAL-VOC ``*.xml`` box annotations (OHC1/2/3 and
IHC, optionally collapsed by ``simple_class``) and :class:`RecursiveStack`
adds ``X.labels.com.tif`` and ``X.labels.vector.pkl``.
"""

from hcunet_tpu_torch.data.datasets import (  # noqa: F401
    RecursiveStack,
    Section,
    Stack,
)

__all__ = ["Stack", "Section", "RecursiveStack"]
