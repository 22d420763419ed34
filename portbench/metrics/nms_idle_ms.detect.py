"""``nms_idle_ms.detect``: the card's idle time inside the program's
``hcunet.detect.nms`` spans (each ``nms_mask`` call, its fixed-point loop
reading one flag back a step), in ms a request of the traced window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.detect.nms")
