"""The port's recurrent serving forward (``infer/compile_recurrent.py``)
against the JAX package's packed compiler, on the CPU (K1's plain version
in place of K1).

Tolerances: float32 at atol 5e-5, and 2e-4 at 10 timesteps (JAX's own
packed-vs-plain tolerances: the recurrence carries rounding from step to
step); RDCNet at 1e-5 of its output's scale (~16).  bfloat16 at 4 % of the
output's scale: the JAX packed convs sum in bfloat16 and K1 in float32, and
each of the 10 tanh/sigmoid steps carries the other's rounding on (both
sit ~1-2 % from the float32 forward at 16^2 x 6).

``split_x`` against unsplit: RDCNet exactly; RecursiveUNet at 1e-5 of the
output's scale, because on the CPU ``F.conv3d`` picks its algorithm by
shape: the gates' first quarter-resolution conv (Cin 32 -> 64) gives
outputs 1.3e-7 apart on the same inputs as one (1, 66, ...) volume and as
four (4, 34, ...) tiles, and 10 timesteps carry that on (measured up to
1.25e-5 at a scale of 4.9, in every column, not at the seams).  An
undersized halo leaks ~4e-2.  On the card K1 sums each voxel's taps in
one order whatever its batch index and position, and ``chip_smoke.py``
holds the split exactly there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.infer import compile_recurrent as jcr
from hcunet_tpu_torch.config import RUNetConfig
from hcunet_tpu_torch.infer import compile_recurrent as tcr
from hcunet_tpu_torch.infer.compile_recurrent import compile_rdcnet_apply, compile_recurrent_apply
from hcunet_tpu_torch.models.runet import RecursiveUNet
from hcunet_tpu_torch.ops.conv import conv3d_valid_plain, conv3d_valid_route
from tests.test_torch_port_recurrent import jax_recurrent, share_of_scale

# name: (family, spatial, config kwargs, skip bug, JAX kwargs, port kwargs, atol)
CASES = {
    "runet_default_32x32x6": ("runet", (32, 32, 6), dict(timesteps=3), False, {}, {}, 5e-5),
    "runet_t10": ("runet", (16, 16, 5), dict(timesteps=10), False, {}, {}, 2e-4),
    "runet_skip_bug": ("runet", (16, 16, 6), dict(timesteps=2), True, {}, {}, 5e-5),
    "runet_fused_tconv": ("runet", (16, 16, 6), dict(timesteps=2), False,
                          dict(subpixel_tconv=False), dict(subpixel_tconv=False), 5e-5),
    "runet_z7": ("runet", (16, 16, 7), dict(timesteps=2), False, {}, {}, 5e-5),
    "rdcnet_t2": ("rdcnet", (16, 16, 10), dict(timesteps=2), False, {}, {}, None),
    "rdcnet_odd_z": ("rdcnet", (16, 16, 9), dict(timesteps=2), False, {}, {}, None),
}


def _inputs(spatial, batch=1, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, *spatial, 4)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_matches_jax_float32(name):
    """The port's serving forward against the JAX packed compiler and the
    JAX ``model.apply``, float32."""
    family, spatial, kw, skip_bug, jkw, tkw, atol = CASES[name]
    model, jmodel, variables = jax_recurrent(family, spatial, skip_bug=skip_bug, **kw)
    x = _inputs(spatial, batch=2 if family == "runet" else 1)
    want = np.asarray(jcr.compile_recurrent_apply(jmodel, variables, dtype=jnp.float32, **jkw)(
        jnp.asarray(x)))
    plain = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    got = compile_recurrent_apply(model, dtype=torch.float32, device="cpu", **tkw)(
        torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == plain.shape
    for ref in (want, plain):
        if atol is None:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_serving_bfloat16_matches_jax(family):
    """bfloat16 serving (the default dtype) against the JAX packed compiler
    in bfloat16 and against the float32 forward, within 4 % of the
    output's scale, 10 timesteps."""
    spatial = (16, 16, 6) if family == "runet" else (16, 16, 10)
    model, jmodel, variables = jax_recurrent(family, spatial, timesteps=10)
    x = _inputs(spatial)
    ref32 = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    jax16 = np.asarray(jcr.compile_recurrent_apply(jmodel, variables, dtype=jnp.bfloat16)(
        jnp.asarray(x)))
    got = compile_recurrent_apply(model, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert share_of_scale(got, jax16) < 0.04
    assert share_of_scale(got, ref32) < 0.04


def test_fallbacks_to_the_plain_forward():
    """x or y not divisible by 4, and a pool other than (2, 2, 1), run the
    model's own forward, as in JAX (which is then ``model.apply``)."""
    model, jmodel, variables = jax_recurrent("runet", (18, 18, 6), timesteps=2)
    x = _inputs((18, 18, 6))
    got = compile_recurrent_apply(model, dtype=torch.float32, device="cpu")(torch.from_numpy(x))
    with torch.no_grad():
        assert torch.equal(got, model(torch.from_numpy(x)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False)),
        rtol=0, atol=5e-5,
    )
    cfg = RUNetConfig(timesteps=2, max_pool_kernel=(2, 2, 2), upsample_stride=(2, 2, 2))
    other = RecursiveUNet(cfg).eval()
    calls = []

    def conv(x, w, b, relu, dilation=1):
        calls.append(1)
        return conv3d_valid_plain(x, w, b, relu, dilation)

    apply = compile_recurrent_apply(other, dtype=torch.float32, device="cpu", conv=conv)
    x = torch.from_numpy(_inputs((16, 16, 8)))
    with torch.no_grad():
        assert torch.equal(apply(x), other(x))
    assert not calls  # the plain forward, not the serving one


def _recording_conv(records):
    def conv(x, w, b, relu, dilation=1):
        records.append((tuple(x.shape), tuple(w.shape), relu, dilation))
        return conv3d_valid_plain(x, w, b, relu, dilation)
    return conv


def test_conv_launches_per_step_and_paths():
    """The serving forwards run every stride-1 conv through ``conv`` (K1):
    RecursiveUNet 20 per timestep (2 in ``down1``, 7 per gate, 3 in
    ``up2``, 1 output conv), 19 on K1's ring path in bfloat16 and the
    9-channel first conv on the basic one; RDCNet 7 per iteration and its
    output conv, all on the basic path (Cin 20, 10, 50 and 10)."""
    model, _jm, _v = jax_recurrent("runet", (16, 16, 5), timesteps=3)
    rec = []
    compile_recurrent_apply(model, device="cpu", conv=_recording_conv(rec))(
        torch.from_numpy(_inputs((16, 16, 5))))
    assert len(rec) == 20 * 3
    routes = [conv3d_valid_route(torch.bfloat16, w[3], w[4]) for _x, w, _r, _d in rec[:20]]
    assert routes.count("ring") == 19 and routes[0] == "basic"
    parity = [w for _x, w, _r, _d in rec[:20] if w[:3] == (3, 3, 5)]
    assert parity == [(3, 3, 5, 64, 128)] * 2 + [(3, 3, 5, 32, 64)]
    assert [r for _x, _w, r, _d in rec[:20]].count(False) == 4  # parity convs, out conv

    rdc, _jm, _v = jax_recurrent("rdcnet", (16, 16, 10), timesteps=3)
    rec = []
    compile_recurrent_apply(rdc, device="cpu", conv=_recording_conv(rec))(
        torch.from_numpy(_inputs((16, 16, 10))))
    assert len(rec) == 7 * 3 + 1
    assert [w[3] for _x, w, _r, _d in rec[:7]] == [20] + [10] * 5 + [50]
    assert [d[0] for _x, _w, _r, d in rec[:7]] == [1, 1, 2, 3, 4, 5, 1]
    assert {conv3d_valid_route(torch.bfloat16, w[3], w[4]) for _x, w, _r, _d in rec} == {"basic"}


def test_split_helpers_properties():
    """``_split_stack`` / ``_halo_refresh`` / ``_split_unstack`` for every
    tile count: unstack(stack(v)) == v; a freshly stacked tiling is a fixed
    point of the refresh; after every halo column is corrupted, one refresh
    restores the stacked tiling; and each equals the JAX helper's output."""
    rng = np.random.default_rng(0)
    vol_np = rng.random((96, 5, 3)).astype(np.float32)
    vol = torch.from_numpy(vol_np)
    for n, halo in ((2, 8), (3, 8), (4, 12), (6, 4)):
        core = 96 // n
        tile = core + (2 * halo if n >= 3 else halo)
        tiles = tcr._split_stack(vol, n, tile, core)
        assert tiles.shape == (n, tile, 5, 3)
        np.testing.assert_array_equal(
            tiles.numpy(), np.asarray(jcr._split_stack(jnp.asarray(vol_np), n, tile, core)))
        assert torch.equal(tcr._split_unstack(tiles, halo)[0], vol)
        assert torch.equal(tcr._halo_refresh(tiles, halo), tiles)
        corrupted = tiles.clone()
        for j in range(n):
            if j > 0:
                corrupted[j, :halo] = -1.0
            if j < n - 1:
                corrupted[j, tile - halo:] = -1.0
        assert torch.equal(tcr._halo_refresh(corrupted, halo), tiles)
        np.testing.assert_array_equal(
            tcr._halo_refresh(corrupted, halo).numpy(),
            np.asarray(jcr._halo_refresh(jnp.asarray(corrupted.numpy()), halo)))
        assert tcr._split_offsets(n, core, tile) == jcr._split_offsets(n, core, tile)


def test_recurrent_split_x_equals_unsplit():
    """RecursiveUNet ``split_x`` 2 and 4 equal the unsplit forward at float32
    within 1e-5 of the output's scale (halo 32 >= the one-step receptive
    radius 28); an undersized halo leaks seam error 100 times that (so the
    split did run); ``halo_x=0`` and B=2 run unsplit."""
    model, _jm, _v = jax_recurrent("runet", (32, 32, 10), timesteps=4)
    x = torch.from_numpy(_inputs((128, 32, 10)))

    def run(inp, **kw):
        return compile_recurrent_apply(model, dtype=torch.float32, device="cpu", **kw)(inp)

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())

    want = run(x)
    assert gap(run(x, split_x=2), want) <= 1e-5
    x4 = torch.from_numpy(_inputs((256, 16, 10), seed=2))
    assert gap(run(x4, split_x=4), run(x4)) <= 1e-5
    assert gap(run(x, split_x=2, halo_x=20), want) > 1e-3
    assert torch.equal(run(x, split_x=2, halo_x=0), want)
    x2 = torch.cat([x, x])
    assert torch.equal(run(x2, split_x=2), run(x2))


def test_rdcnet_split_x_equals_unsplit():
    """RDCNet ``split_x`` 2 and 4 (half-resolution tiles, halo 12) equal the
    unsplit forward exactly at float32; an undersized halo (8) leaks."""
    model, _jm, _v = jax_recurrent("rdcnet", (32, 32, 10), timesteps=4)

    def run(inp, **kw):
        return compile_rdcnet_apply(model, dtype=torch.float32, device="cpu", **kw)(inp)

    x = torch.from_numpy(_inputs((96, 32, 10)))
    want = run(x)
    assert torch.equal(run(x, split_x=2), want)
    x4 = torch.from_numpy(_inputs((224, 16, 10), seed=2))
    assert torch.equal(run(x4, split_x=4), run(x4))
    assert (run(x, split_x=2, halo_x=8) - want).abs().max() > 1e-4
    assert torch.equal(compile_recurrent_apply(model, dtype=torch.float32, device="cpu",
                                               split_x=2)(x), want)
