"""``merge_idle_ms.detect``: the card's idle time inside the program's
``hcunet.detect.merge`` span (``collect_cell_candidates``: the read-back of
the detections and the host NMS merge per plane), in ms a request of the
traced window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.detect.merge")
