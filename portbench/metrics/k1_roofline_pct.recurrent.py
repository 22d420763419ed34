"""``k1_roofline_pct.recurrent``: K1's least time over its device time in the
recurrent serving window (the same-padded convs and the stacked parity
convs of the transposed convs)."""

from portbench.readers import k1_roofline_pct


def read(obs):
    return k1_roofline_pct(obs)
