"""``idle_in_program_pct.recurrent``: the share of the traced window's device
idle time that falls inside the program's ``hcunet.recurrent.forward`` span,
not in the read-back and the harness around the calls."""

from portbench.spans import idle_in_program_pct


def read(obs):
    return idle_in_program_pct(obs, "hcunet.recurrent.forward")
