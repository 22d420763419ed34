"""``nms_steps_per_request.detect``: the steps of ``nms_mask``'s fixed point
(each one flag read back from the card) a request of the traced window,
from the program's ``NMS_STEPS`` counter."""


def read(obs):
    steps = obs.counters.get("nms_steps")
    if not steps or not obs.requests:
        return None
    return steps / len(obs.requests)
