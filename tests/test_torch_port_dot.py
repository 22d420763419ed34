"""K3's plain version (``hcunet_tpu_torch/ops/dot.py::dot_blocked_plain``)
against the TPU kernel it replaces, ``scripts/probe_pallas_dot.py::pallas_dot``,
run in Pallas interpret mode on the CPU.

Tolerances: float32 within 1e-5 x max|ref| (both sum in float32, in other
orders); bfloat16 within one bf16 rounding, 2^-7 x max|ref| (both round the
float32 sum once, and may land on either side of a rounding boundary).  The
kernel itself is held to the plain version on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu_torch.ops.dot import DOT_BLOCKED, dot_blocked, dot_blocked_plain

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    """``scripts/probe_pallas_dot.py``, imported by path (it is a script)."""
    path = os.path.join(REPO_ROOT, "scripts", "probe_pallas_dot.py")
    spec = importlib.util.spec_from_file_location("probe_pallas_dot", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, X, Y, K, N, tx): one block, several row blocks, K and N not multiples
# of 16, a single row
CASES = [(1, 4, 6, 32, 16, 4), (2, 6, 5, 24, 40, 2), (1, 3, 7, 72, 9, 3), (1, 1, 1, 13, 5, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dot_blocked_plain_matches_pallas_dot(probe, monkeypatch, case, dtype):
    monkeypatch.setattr(
        probe.pl, "pallas_call", functools.partial(probe.pl.pallas_call, interpret=True)
    )
    B, X, Y, K, N, tx = CASES[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal((B, X, Y, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    # the same (bf16-representable) inputs on both sides
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want = np.asarray(probe.pallas_dot(xj, wj, tx).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(tdt)
    before = DOT_BLOCKED.launches
    got = dot_blocked(xt, wt)
    assert DOT_BLOCKED.launches == before  # the CPU runs the plain version
    assert got.dtype == tdt and got.shape == (B, X, Y, N)
    np.testing.assert_array_equal(got.float().numpy(), dot_blocked_plain(xt, wt).float().numpy())
    scale = max(1.0, float(np.abs(want).max()))
    tol = (1e-5 if dtype == "float32" else 2.0**-7) * scale
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_dot_blocked_rejects_what_it_does_not_take():
    x = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError, match="expected"):
        dot_blocked(x, torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="no kernel"):
        dot_blocked(x.to("meta"), torch.zeros((4, 2), device="meta"))
    with pytest.raises(ValueError, match="w on"):
        dot_blocked(x, torch.zeros((4, 2), device="meta"))
