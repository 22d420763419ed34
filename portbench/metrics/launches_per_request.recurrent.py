"""``launches_per_request.recurrent``: device kernels launched per request
of the recurrent serving forward, from the profiler's trace."""


def read(obs):
    if not obs.requests:
        return None
    n = sum(1 for _ in obs.trace.in_window(("kernel",)))
    return n / len(obs.requests) if n else None
