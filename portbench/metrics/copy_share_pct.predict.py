"""``copy_share_pct.predict``: the share of a ``Segmenter.predict`` window in
which the card copied between host and device (the union of the
profiler's host-to-device and device-to-host copies)."""

from portbench.readers import copy_share_pct


def read(obs):
    return copy_share_pct(obs)
