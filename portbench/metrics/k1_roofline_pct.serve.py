"""``k1_roofline_pct.serve``: K1's least time over its device time in the
float32 chunk's window (the serving forward's valid convs)."""

from portbench.readers import k1_roofline_pct


def read(obs):
    return k1_roofline_pct(obs)
