"""``copy_share_pct.recurrent``: the share of the recurrent serving window in
which the card copied between host and device (the pageable upload and
read-back; the union of the profiler's host-to-device and device-to-host
copies)."""

from portbench.readers import copy_share_pct


def read(obs):
    return copy_share_pct(obs)
