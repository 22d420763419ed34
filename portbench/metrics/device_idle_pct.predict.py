"""``device_idle_pct.predict``: the share of a ``Segmenter.predict`` window
in which the card ran nothing (kernels, copies and memsets from the
profiler's trace)."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
