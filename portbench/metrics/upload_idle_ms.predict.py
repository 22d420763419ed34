"""``upload_idle_ms.predict``: the card's idle time inside the program's
``hcunet.tiling.upload`` span (``predict_segmentation_mask``'s copy of the
host array to a tensor on the card), in ms a request of the traced
window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.tiling.upload")
