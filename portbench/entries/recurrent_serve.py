"""Entry ``recurrent_serve``: the RecursiveUNet's serving forward as
``predict-recurrent`` runs it on one stack.

The program: the configuration's RecursiveUNet with the benchmark's
weights, in eval mode, through ``infer/compile_recurrent.py::
compile_recurrent_apply`` in the mix's dtype with ``split_x=1`` (the
command's default).  Each request hands it a ``[1, X, Y, Z, 4]`` float32
CPU tensor over a host volume and returns with the head ``[1, X, Y, Z, 5]``
on the host as numpy.  The check compares all five channels of each
sampled request's head with the reference's.
"""

from __future__ import annotations

import torch

from portbench import flops
from portbench.inputs import make_volume
from portbench.reference.precision import Precision


def runet_config(cfg: dict):
    from hcunet_tpu_torch.config import RUNetConfig

    return RUNetConfig(**{k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
                          for k in ("in_channels", "out_channels", "channels", "kernel",
                                    "upsample_kernel", "max_pool_kernel", "upsample_stride",
                                    "timesteps")})


def build_model(run):
    """The program's RecursiveUNet on the run's device with the benchmark's
    weights."""
    from hcunet_tpu_torch.models.runet import RecursiveUNet

    model = RecursiveUNet(runet_config(run.config)).to(run.device)
    state = model.state_dict()
    state.update(run.weights)
    model.load_state_dict(state)
    return model


def counters(state) -> dict:
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID

    return {"k1": CONV3D_VALID.launches}


def setup(run):
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply

    model = build_model(run).eval()
    apply_fn = compile_recurrent_apply(model, dtype=run.dtype, device=run.device)
    volumes = {r.index: make_volume(r.shape, r.seed, run.device).cpu().numpy()
               for r in run.requests}
    state = {"apply": apply_fn, "volumes": volumes}
    del model
    # ``warmup`` requests, cycling through the pool: after only two, the
    # window's first half second of requests ran some 15 % slower
    for k in range(int(run.mix.get("warmup", 2))):
        request(state, run.requests[k % len(run.requests)])
    return state


def request(state, item):
    batch = torch.from_numpy(state["volumes"][item.index][None])
    return state["apply"](batch).cpu().numpy()


def release(state) -> None:
    state.pop("apply", None)


def k1_launches(run, item):
    return flops.runet_serve_k1_launches(run.config, item.shape, 1)


def head_numbers(pairs) -> dict:
    """Per output channel, over the sampled requests: the root-mean-square
    gap over the reference's root-mean-square, and the widest gap over the
    reference's widest magnitude; the worst channel of each."""
    got = torch.cat([g.reshape(-1, g.shape[-1]) for g, _ in pairs]).double()
    want = torch.cat([w.reshape(-1, w.shape[-1]) for _, w in pairs]).double()
    d = got - want
    out = {"head_rel_rms": 0.0, "head_rel_max": 0.0}
    for c in range(want.shape[-1]):
        scale_rms = float(want[:, c].pow(2).mean().sqrt().clamp_min(1e-30))
        scale_max = float(want[:, c].abs().max().clamp_min(1e-30))
        out["head_rel_rms"] = max(out["head_rel_rms"],
                                  float(d[:, c].pow(2).mean().sqrt()) / scale_rms)
        out["head_rel_max"] = max(out["head_rel_max"], float(d[:, c].abs().max()) / scale_max)
    return out


def reference_heads(run, volumes, precision: str):
    P = Precision(precision, run.device)
    return [run.reference.serve(run.weights, run.config,
                                torch.from_numpy(v[None]).to(run.device), P)[0]
            for v in volumes]


def check(run, state) -> dict:
    pairs = []
    for item, out in run.sampled():
        want = reference_heads(run, [state["volumes"][item.index]], "float32")[0]
        pairs.append((torch.from_numpy(out[0]).to(run.device), want))
    return head_numbers(pairs)


def control(run, precision: str) -> dict:
    """The numbers of the reference in ``precision`` put in the program's
    place, on the first ``sample`` requests of the pool."""
    vols = [make_volume(r.shape, r.seed, run.device).cpu().numpy()
            for r in run.requests[: run.sample_size]]
    return head_numbers(list(zip(reference_heads(run, vols, precision),
                                 reference_heads(run, vols, "float32"))))
