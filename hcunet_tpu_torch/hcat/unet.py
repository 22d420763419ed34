"""``hcat.unet``: the generic U-Net constructor module, as the valscripts
driver imports it (``from hcat.unet import Unet_Constructor as GUnet``).

``Unet_Constructor`` is the facade's ``unet`` class: the reference's
constructor keywords and array layout, ``forward``/``save``/``load`` (the
reference's ``.unet`` files among them), on the port's U-Net.
"""

from hcunet_tpu_torch.compat import unet as Unet_Constructor  # noqa: F401

__all__ = ["Unet_Constructor"]
