"""The traffic generator and the inputs: the same seed gives the same
requests, weights and volumes; every seed gets the same set of sizes."""

from __future__ import annotations

import json

import torch

from portbench import generator
from portbench.inputs import make_volume, make_weights, sub_seed
from portbench.tests.conftest import ROOT

BIG = 2**31 + 2**30 + 12345  # larger than 32 signed bits hold


def _mix(name):
    return json.loads((ROOT / "portbench/traffic" / f"{name}.json").read_text())


def test_pool_is_reproducible_from_the_seed():
    mix = _mix("predict-mixed-bf16")
    a, b = generator.pool(mix, BIG), generator.pool(mix, BIG)
    assert a == b
    c = generator.pool(mix, BIG + 1)
    # another seed: the same sizes in another order, with other content
    assert sorted(r.shape for r in a) == sorted(r.shape for r in c)
    assert [r.shape for r in a] != [r.shape for r in c]
    assert {r.seed for r in a}.isdisjoint({r.seed for r in c})


def test_mixed_sizes_are_drawn_from_their_ranges():
    mix = _mix("predict-mixed-bf16")
    shapes = [r.shape for r in generator.pool(mix, 1)]
    assert len(shapes) == mix["pool"]
    for axis, key in enumerate("xyz"):
        lo, hi = mix["ranges"][key]
        assert all(lo <= s[axis] <= hi for s in shapes)
    assert len({s[2] for s in shapes}) > 1


def test_fixed_shape_mixes():
    for name in ("chunk2304-f32", "b1-256-bf16"):
        mix = _mix(name)
        pool = generator.pool(mix, BIG)
        assert {r.shape for r in pool} == {tuple(mix["shape"])}
        assert sorted(r.index for r in pool) == list(range(mix["pool"]))


def test_inputs_are_reproducible_from_the_seed():
    assert sub_seed(BIG, "weights") == sub_seed(BIG, "weights") != sub_seed(BIG, "sample")
    specs = [("a.weight", (3, 4), "normal", 0.5), ("b.weight", (5,), "uniform", 0.2)]
    w1, w2 = make_weights(specs, 9, "cpu"), make_weights(specs, 9, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["b.weight"].min()) >= 0.8 and float(w1["b.weight"].max()) <= 1.2
    v1, v2 = make_volume((20, 18, 5), 4, "cpu"), make_volume((20, 18, 5), 4, "cpu")
    assert torch.equal(v1, v2) and v1.shape == (20, 18, 5, 4)
    assert float(v1.min()) >= -1 and float(v1.max()) <= 1 and float(v1.std()) > 0.01
    assert not torch.equal(v1, make_volume((20, 18, 5), 5, "cpu"))
