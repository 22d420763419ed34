"""The one traffic generator: it reads a traffic mix's data file
(``portbench/traffic/<mix>.json``) and gives the run's requests.

A mix names the entry its requests go to, the dtype the program serves
them in, and the requests' sizes: ``shape`` (every request alike) or
``ranges`` (each axis drawn uniformly from ``[lo, hi]``).  Sizes are
drawn once from the mix's own ``size_seed``, so every run seed gets the
same set of ``pool`` sizes, woven largest to smallest; the run seed picks
where that cycle starts and makes each request's content.  The
window cycles through the pool in that order, one request at a time (a
closed loop with one client).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from portbench.inputs import sub_seed


@dataclass(frozen=True)
class Request:
    index: int                  # position in the pool
    shape: Tuple[int, int, int]  # [X, Y, Z] voxels
    seed: int                   # the seed of its content

    @property
    def voxels(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]


def pool(mix: dict, seed: int) -> List[Request]:
    """The mix's ``pool`` requests for a run of ``seed``, in the order the
    window sends them."""
    n = int(mix["pool"])
    if "shape" in mix:
        shapes = [tuple(int(s) for s in mix["shape"])] * n
    else:
        rng = np.random.default_rng(int(mix.get("size_seed", 0)))
        axes = [mix["ranges"][a] for a in ("x", "y", "z")]
        shapes = [tuple(int(rng.integers(lo, hi + 1)) for lo, hi in axes) for _ in range(n)]
    # largest, smallest, second largest, second smallest, ...: every run of
    # consecutive requests holds about the pool's mix of sizes; the seed
    # picks where the cycle starts
    by_size = sorted(range(n), key=lambda k: (-np.prod(shapes[k]), k))
    woven = [by_size[i // 2] if i % 2 == 0 else by_size[n - 1 - i // 2] for i in range(n)]
    start = int(np.random.default_rng(sub_seed(seed, "order")).integers(n))
    order = woven[start:] + woven[:start]
    return [Request(int(k), shapes[k], sub_seed(seed, "request", int(k))) for k in order]
