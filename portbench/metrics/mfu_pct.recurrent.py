"""``mfu_pct.recurrent``: the model's FLOPs for the stacks served over the
window times the compute dtype's peak."""

from portbench.readers import mfu_pct


def read(obs):
    return mfu_pct(obs)
