"""``k1_roofline_pct.predict``: K1's least time over its device time in a
``Segmenter.predict`` window (the forward's valid convs over each bucket's
tile batches)."""

from portbench.readers import k1_roofline_pct


def read(obs):
    return k1_roofline_pct(obs)
