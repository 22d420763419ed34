"""``timestep_idle_pct.recurrent``: the share of the program's
``hcunet.recurrent.timestep`` spans in which the card ran nothing: the card
waiting on the host's launches of the timesteps."""

from portbench.spans import idle_share_of_span_pct


def read(obs):
    return idle_share_of_span_pct(obs, "hcunet.recurrent.timestep")
