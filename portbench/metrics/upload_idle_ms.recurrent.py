"""``upload_idle_ms.recurrent``: the card's idle time inside the program's
``hcunet.recurrent.upload`` span (the recurrent forward's copy of the host
tensor to the card in the compute dtype), in ms a request of the traced
window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.recurrent.upload")
