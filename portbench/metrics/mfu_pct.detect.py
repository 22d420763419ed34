"""``mfu_pct.detect``: the detector's model FLOPs over every window of the
tile grid of each request served (repeated windows included, as the
program runs them; :mod:`portbench.flops_detect`) over the window's length
times the float32 peak."""

from portbench import flops, flops_detect


def read(obs):
    run = obs.run
    if obs.trace.window_s <= 0 or not obs.requests:
        return None
    work = sum(flops_detect.windows_flops(run.config,
                                          run.reference.window_sizes(run.config, *item.shape[:2]),
                                          item.shape[2])
               for item in obs.requests)
    return 100.0 * work / (obs.trace.window_s * flops.PEAK_FLOPS[run.dtype_name])
