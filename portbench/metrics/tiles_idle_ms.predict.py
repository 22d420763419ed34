"""``tiles_idle_ms.predict``: the card's idle time inside the program's
``hcunet.tiling.tiles`` span (the scrub, the halo pad, the tile loop with its
stitch, the trim and the epilogue), in ms a request of the traced window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.tiling.tiles")
