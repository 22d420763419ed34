"""``hcat.train``: the training subpackage, as the drivers import it
(``import hcat.train``, ``from hcat.train import train_utils``)."""

from typing import List, Tuple

from hcunet_tpu_torch.hcat.train import train_utils  # noqa: F401


def frcnn(model, dataloader, optimizer=None, scheduler=None,
          epochs: int = 100, lr: float = 1e-5, gamma: float = 0.997,
          device=None, scale: float = 1.0) -> Tuple[object, List[float]]:
    """``hcat.train.frcnn`` (``train_fastercnn_func.py:8-70``): the epoch
    loop over a Section-style dataset (``dataset[i]`` gives ``(image,
    {'boxes', 'labels'})``) with the reference's loss sum
    (``loss_classifier`` times ``scale``), AdamW and a per-epoch
    exponential decay, by the port's
    :class:`~hcunet_tpu_torch.train.detection_trainer.DetectionTrainer`.
    Returns ``(model, summed_losses)`` like the reference
    (``train_rcnn.py:68``).

    ``model`` is the facade's detector (:func:`hcunet_tpu_torch.compat.rcnn`)
    and trains where it lives, in place, so the facade serves the trained
    weights; a given ``device`` moves it there first, as the reference's
    ``model.to(device)``.  ``optimizer`` and ``scheduler`` are accepted and
    ignored, as in the JAX alias: the recipe is set by ``lr``, ``gamma`` and
    ``scale``, which the reference driver passes beside them
    (``train_rcnn.py:59-68``)."""
    from hcunet_tpu_torch.train.detection_trainer import (
        DetectionTrainConfig,
        DetectionTrainer,
    )

    del optimizer, scheduler
    model.to(device)
    trainer = DetectionTrainer(
        model.detector,
        None,
        DetectionTrainConfig(learning_rate=lr, gamma=gamma, classifier_scale=scale,
                             epochs=epochs),
        steps_per_epoch=max(len(dataloader), 1),
        device=model.detector.device,
    )
    return model, trainer.fit(dataloader, epochs=epochs)


__all__ = ["frcnn", "train_utils"]
