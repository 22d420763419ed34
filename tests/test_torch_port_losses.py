"""The port's losses (``hcunet_tpu_torch/train/losses.py``) against the JAX
package's (``hcunet_tpu/train/losses.py``), values and gradients, on numpy
inputs.

Tolerances: both compute in float32 (reductions in other orders), so values
within 1e-6 relative and gradients within 1e-5 of their scale.  The
``random`` method draws from another generator than JAX's, so it is held by
its structure: the same generator seed gives the same value, inputs where
the draw cannot matter give JAX's value, and the arguments are checked as
JAX checks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.train import losses as jl
from hcunet_tpu_torch.train import losses as tl

SHAPES = {"3d": ((2, 9, 8, 5, 1), (2, 11, 10, 7, 1)), "2d": ((2, 9, 8, 1), (2, 12, 9, 1))}


def _inputs(dim, seed=0):
    """Logits and the spatially larger mask and weight map (cropped by the
    losses to the logits' shape)."""
    pred_shape, target_shape = SHAPES[dim]
    rng = np.random.default_rng(seed)
    pred = (rng.standard_normal(pred_shape) * 2).astype(np.float32)
    mask = (rng.random(target_shape) > 0.6).astype(np.float32)
    pwl = (rng.random(target_shape) * 3).astype(np.float32)
    return pred, mask, pwl


def _value_and_grad(jfn, tfn, pred):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tv = tfn(p)
    tv.backward()
    return (float(tv.detach()), p.grad.numpy()), (float(jv), np.asarray(jg))


def _assert_match(got, want):
    (tv, tg), (jv, jg) = got, want
    assert abs(tv - jv) <= 1e-6 * max(1.0, abs(jv)), (tv, jv)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * max(np.abs(jg).max(), 1e-12))


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("method", ["pixel", "worst_z", "sigmoid"])
@pytest.mark.parametrize("weights", ["pwl", "none", "boost"])
def test_cross_entropy_matches_jax(method, weights, dim):
    pred, mask, pwl = _inputs(dim)
    kw = dict(method=method)
    if weights == "boost":
        kw["foreground_boost"] = 2.0
    w = None if weights == "none" else pwl
    got, want = _value_and_grad(
        lambda p: jl.cross_entropy(p, mask, None if w is None else jnp.asarray(w), **kw),
        lambda p: tl.cross_entropy(p, torch.from_numpy(mask), None if w is None else w, **kw),
        pred,
    )
    _assert_match(got, want)


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("name", ["dice", "l1_loss", "mse_loss"])
def test_dice_l1_mse_match_jax(name, dim):
    pred, mask, _ = _inputs(dim, seed=1)
    got, want = _value_and_grad(
        lambda p: getattr(jl, name)(p, jnp.asarray(mask)),
        lambda p: getattr(tl, name)(p, mask),
        pred,
    )
    _assert_match(got, want)


def test_cross_entropy_random_structure():
    """``method="random"``: deterministic under one generator seed, other
    draws under another; JAX's value wherever the draw cannot matter (a
    constant logit per class, or no positive pixel: the mean over all
    pixels); and the argument checks of the JAX twin."""
    pred, mask, _ = _inputs("3d", seed=2)
    t = torch.from_numpy(pred)

    def draw(seed):
        return float(tl.cross_entropy(t, mask, method="random", num_random_pixels=16,
                                      generator=torch.Generator().manual_seed(seed)))

    assert draw(3) == draw(3)
    assert len({draw(s) for s in range(6)}) > 1
    per_pixel = tl._bce_with_logits(t, tl._crop_like(mask, t))
    assert float(per_pixel.min()) <= draw(4) <= float(per_pixel.max())

    cropped = mask[:, :9, :8, :5]
    flat = np.where(cropped > 0.5, 1.5, -0.5).astype(np.float32)
    for m, p in ((mask, flat), (np.zeros_like(mask), pred)):
        want = float(jl.cross_entropy(jnp.asarray(p), jnp.asarray(m), method="random",
                                      num_random_pixels=16, key=jax.random.PRNGKey(0)))
        got = float(tl.cross_entropy(torch.from_numpy(p), m, method="random", num_random_pixels=16,
                                     generator=torch.Generator().manual_seed(0)))
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)

    p = torch.tensor(pred, requires_grad=True)
    tl.cross_entropy(p, mask, method="random", num_random_pixels=16,
                     generator=torch.Generator().manual_seed(5)).backward()
    assert 0 < int((p.grad != 0).sum()) <= 32  # only the drawn pixels
    with pytest.raises(ValueError, match="num_random_pixels"):
        tl.cross_entropy(t, mask, method="random", num_random_pixels=1,
                         generator=torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        tl.cross_entropy(t, mask, method="random", num_random_pixels=4)
    with pytest.raises(ValueError, match="viable methods"):
        tl.cross_entropy(t, mask, method="other")
