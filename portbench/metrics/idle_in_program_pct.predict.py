"""``idle_in_program_pct.predict``: the share of the traced window's device
idle time that falls inside the program's ``hcunet.serve.predict`` span,
not in the harness around the calls."""

from portbench.spans import idle_in_program_pct


def read(obs):
    return idle_in_program_pct(obs, "hcunet.serve.predict")
