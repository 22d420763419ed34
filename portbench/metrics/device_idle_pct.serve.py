"""``device_idle_pct.serve``: the share of the float32 chunk's window in which
the card ran nothing (kernels, copies and memsets from the profiler's trace)."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
