"""``hcat.rcnn``: the detection-head factory.  ``rcnn(path)`` returns a
detector with the torchvision contract (``model(images)`` gives a list of
``{'boxes', 'labels', 'scores'}``), from the packages' checkpoints or a
torchvision ``fasterrcnn_resnet50_fpn`` state dict.
"""

from hcunet_tpu_torch.compat import rcnn  # noqa: F401

__all__ = ["rcnn"]
