"""``readback_idle_ms.predict``: the card's idle time inside the program's
``hcunet.serve.readback`` span (``Segmenter.predict``'s copy of the map to
a host array), in ms a request of the traced window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.serve.readback")
