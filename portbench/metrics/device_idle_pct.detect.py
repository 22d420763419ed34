"""``device_idle_pct.detect``: the share of a window of ``analyze``'s
detection stage in which the card ran nothing (kernels, copies and memsets
from the profiler's trace)."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
