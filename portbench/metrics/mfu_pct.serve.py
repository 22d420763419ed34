"""``mfu_pct.serve``: the model's FLOPs for the chunks served over the window
times the compute dtype's peak."""

from portbench.readers import mfu_pct


def read(obs):
    return mfu_pct(obs)
