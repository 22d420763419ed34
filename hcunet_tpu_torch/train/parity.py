"""How far two training runs of the U-Net from the same start may part.

The one rule that holds two runs to each other (the port against the JAX
trainer, a resumed run against an uninterrupted one, K1 against the plain
conv on the card).  Runs are compared as the JAX ``{"params",
"batch_stats"}`` tree (``UNetTrainer.variables``), as numpy.

Adam divides each step by the root of the squared gradient's average, so
an element whose gradient is near 0 (a rounding difference away from the
other sign) can move a whole step of lr apart in two runs.  So the rule
does not hold parameters element by element: it gives, per tensor, the
share of elements more than ``far`` lr apart and the running statistics'
gap relative to their scale, and it raises where a parameter did not
move, is not finite, or two runs part by more than Adam's step bound.

The BN-cancelled biases (:func:`bn_cancelled`) have a gradient of 0 up to
rounding, so they are held to the step bound alone, and the running means
(which take 0.1 of them a step) get the bound as slack.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

# two Adam runs part by at most this many lr a step: each moves an element
# by lr |m_hat| / sqrt(v_hat), which is at most sqrt(sum_i a_i^2 / b_i)
# lr at step t (Cauchy-Schwarz over the moments' weights a_i, b_i): 1.0,
# 1.0014, 1.0036, 1.0068, 1.0108 for t = 1..5 at (0.9, 0.999), so two runs
# part by at most 10.045 lr in 5 steps, within 2.01 lr a step
ADAM_STEP_BOUND = 2.01
MAX_STEPS = 5
# a parameter element counts as parted when it is this many lr apart
FAR = 0.1

Path = Tuple[str, ...]


def flat(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """``{path: leaf}`` of a nested dict, leaves as float32 numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def bn_cancelled(path: Path) -> bool:
    """A bias that reaches a train-mode batch norm only through linear
    layers, as a constant per channel, which the batch norm subtracts again:
    every conv bias but the output conv's (``up_bias`` through the next
    conv).  Its gradient is 0 up to rounding."""
    return path[-1] == "up_bias" or (path[-1] == "bias" and path[-2].startswith("ConvBNRelu"))


def gradient_gaps(got: Mapping, want: Mapping) -> Dict[Path, float]:
    """Per gradient tensor (JAX ``params`` trees), the norm of the
    difference over the norm of ``want``; the BN-cancelled biases left out."""
    g, w = flat(got), flat(want)
    if g.keys() != w.keys():
        raise AssertionError(f"gradient trees differ: {sorted(g.keys() ^ w.keys())}")
    return {p: float(np.linalg.norm(g[p] - v) / np.linalg.norm(v))
            for p, v in w.items() if not bn_cancelled(p)}


def trajectory_gaps(got: Mapping, want: Mapping, start: Mapping, lr: float,
                    steps: int, far: float = FAR) -> Dict[Tuple[str, Path], float]:
    """Two runs of ``steps`` Adam steps at (at most) ``lr`` from the
    variables ``start``; ``got`` and ``want`` the variables after them.
    Returns ``{("share", path): share of the elements more than far lr
    apart}`` for the parameters but the BN-cancelled biases, and
    ``{("stats", path): gap over max(1, scale)}`` for the running
    statistics (a running mean's gap less the step bound).  Raises where
    a tensor is not finite, a parameter but a BN-cancelled bias did not
    move, or the two runs part by more than ``ADAM_STEP_BOUND`` lr a step."""
    if steps > MAX_STEPS:
        raise ValueError(f"the step bound is shown for at most {MAX_STEPS} steps, not {steps}")
    bound = ADAM_STEP_BOUND * lr * steps
    gaps = {}
    for coll in ("params", "batch_stats"):
        g, w, s = flat(got[coll]), flat(want[coll]), flat(start[coll])
        if g.keys() != w.keys():
            raise AssertionError(f"{coll} trees differ: {sorted(g.keys() ^ w.keys())}")
        for path, wv in w.items():
            if not np.isfinite(g[path]).all():
                raise AssertionError(f"{path} is not finite")
            gap = np.abs(g[path] - wv)
            if coll == "batch_stats":
                slack = bound if path[-1] == "mean" else 0.0
                gaps["stats", path] = max(0.0, float(gap.max()) - slack) / max(1.0, float(np.abs(wv).max()))
                continue
            if float(gap.max()) > bound:
                raise AssertionError(f"{path}: {float(gap.max()) / lr:.2f} lr apart, beyond "
                                     f"Adam's step bound {ADAM_STEP_BOUND * steps:.2f} lr")
            if bn_cancelled(path):
                continue
            if float(np.abs(wv - s[path]).max()) == 0.0:
                raise AssertionError(f"{path} did not move")
            gaps["share", path] = float((gap > far * lr).mean())
    return gaps
