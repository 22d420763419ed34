"""``copy_share_pct.serve``: the share of the float32 chunk's window in which
the card copied between host and device (the union of the profiler's
host-to-device and device-to-host copies; only a checksum comes back)."""

from portbench.readers import copy_share_pct


def read(obs):
    return copy_share_pct(obs)
