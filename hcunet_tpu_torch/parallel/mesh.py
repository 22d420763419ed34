"""Device mesh and axis conventions (twin of ``hcunet_tpu/parallel/mesh.py``).

A :class:`Mesh` is named axes over an array of ``torch.device`` entries, held
by one process: the JAX mesh is single-controller, and so is this one.  A
multi-device entry point takes the whole volume or the global batch in one
call, puts each shard on its device, moves halos and results between
devices with device-to-device copies (``.to(dst, non_blocking=True)``, the
counterpart of the JAX package's collectives) and returns the whole result.
Entries may repeat: ``make_mesh({SPATIAL_AXIS: 2}, ["cuda:0"] * 2)`` runs
both shards on one card, every shard through the same kernels, and
``["cpu"] * 8`` is the tests' counterpart of JAX's 8-device virtual CPU
mesh.  On a node with several cards, one shard goes to each card.

Axis conventions, as in the JAX package:

* ``data``    — batch / independent-sample parallelism;
* ``model``   — channel parallelism over conv feature dimensions;
* ``spatial`` — sharding of a volume's X axis with halo exchange.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPATIAL_AXIS = "spatial"


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a bare ``"cuda"``
    names the current card, so that two spellings of one card compare
    equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (``devices``, of
    shape ``tuple(shape.values())``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        the shards of a tensor split over ``axis`` alone live (the others
        replicate it, and only these compute it)."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def require_mesh(mesh) -> Mesh:
    """``mesh``, which must be a :class:`Mesh` (a ``TypeError`` otherwise)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a hcunet_tpu_torch.parallel.mesh.Mesh, got {mesh!r}")
    return mesh


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh; by default every CUDA device on one ``data`` axis.

    ``axis_sizes`` maps axis name -> size; the sizes must multiply to the
    number of devices (a trailing axis may be -1 to take the rest).
    ``devices`` lists the mesh's devices in order; entries may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def default_multichip_mesh(n_devices: int, devices=None) -> Mesh:
    """The standard mesh: data × model × spatial, falling back by axis
    (spatial, then model) for counts that do not factor."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if n_devices >= 8 and n_devices % 4 == 0:
        return make_mesh(
            {DATA_AXIS: n_devices // 4, MODEL_AXIS: 2, SPATIAL_AXIS: 2}, devices
        )
    if n_devices >= 4 and n_devices % 2 == 0:
        return make_mesh({DATA_AXIS: n_devices // 2, MODEL_AXIS: 2}, devices)
    return make_mesh({DATA_AXIS: n_devices}, devices)


class Placement:
    """Where the shards of a tensor's leading axis live: shard ``k`` of
    ``len(devices)`` equal, contiguous shards on ``devices[k]``."""

    def __init__(self, mesh: Mesh, devices: Sequence[torch.device]):
        self.mesh = mesh
        self.devices = list(devices)

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t``'s leading axis in ``len(devices)`` contiguous pieces, each
        copied to its device (a piece already there is not copied)."""
        n = len(self.devices)
        if t.shape[0] % n:
            raise ValueError(
                f"a leading axis of {t.shape[0]} cannot split evenly over {n} devices"
            )
        return [p.to(d, non_blocking=True) for p, d in zip(t.chunk(n), self.devices)]


def batch_sharding(mesh: Mesh) -> Placement:
    """Split the leading (batch) axis over ``data``, replicated over the
    other axes (a mesh without a ``data`` axis keeps the batch whole on its
    first device)."""
    if DATA_AXIS not in mesh.axis_names:
        return Placement(mesh, [mesh.devices.flat[0]])
    return Placement(mesh, mesh.axis_devices(DATA_AXIS))


def tiles_sharding(mesh: Mesh, n: Optional[int] = None) -> Placement:
    """Split a leading tile/slab axis over EVERY mesh device, flattened, as
    ``PartitionSpec((axis0, axis1, ...))`` does.  ``n`` (the tile count)
    must be a multiple of the device count."""
    if n is not None and int(n) % mesh.size != 0:
        raise ValueError(
            f"{n} tiles cannot shard evenly over the {mesh.size}-device "
            f"mesh {dict(mesh.shape)}; pick split/batch a multiple of "
            f"{mesh.size}"
        )
    return Placement(mesh, list(mesh.devices.flat))


def param_sharding_spec(shape: Sequence[int], mesh: Mesh, min_size: int = 32) -> tuple:
    """The JAX package's rule for one parameter of JAX shape ``shape``:
    shard the trailing (out-feature) axis over ``model`` when it divides
    evenly and is at least ``min_size``.  Returns the spec as a tuple
    (``()`` for replicated)."""
    if MODEL_AXIS not in mesh.axis_names:
        return ()
    m = mesh.shape[MODEL_AXIS]
    if len(shape) >= 1 and shape[-1] % m == 0 and shape[-1] >= min_size:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


# a probe value is identity * _PROBE + index; float32 holds it exactly while
# it stays below 2**24 (identities < 1024, axes < 16384)
_PROBE = 2**14


def shard_params(
    state_dict: Mapping[str, torch.Tensor],
    param_names: Sequence[str],
    mesh: Mesh,
    to_jax: Callable[[Dict[str, torch.Tensor]], Mapping],
    min_size: int = 32,
) -> Dict[str, Optional[int]]:
    """:func:`param_sharding_spec` over a model's parameters, on their JAX
    shapes: for each name of ``param_names``, the torch dim that the
    ``model`` axis splits, or None.

    ``to_jax`` is the model's state-dict -> JAX variable tree converter
    (``utils/port_jax.py``).  It tells each parameter's JAX shape and
    which torch dim becomes the JAX trailing axis (dim 0 of a conv's or a
    linear's weight, dim 1 of a transposed conv's): each dim in turn is
    probed with values that encode the parameter and the index along that
    dim, and read back from the tree."""
    split: Dict[str, Optional[int]] = dict.fromkeys(param_names)
    if MODEL_AXIS not in mesh.axis_names:
        return split
    names = list(param_names)
    if len(names) >= 2**24 // _PROBE:
        raise ValueError(f"too many parameters ({len(names)}) to probe")
    ident = {n: i for i, n in enumerate(names)}
    max_dim = max(state_dict[n].ndim for n in names)
    for d in range(max_dim):
        probe = {}
        for name, t in state_dict.items():
            if name in ident:
                if t.ndim > d:
                    shape = [1] * t.ndim
                    shape[d] = -1
                    idx = torch.arange(t.shape[d], dtype=torch.float32).view(shape)
                else:
                    idx = torch.zeros(())
                probe[name] = (ident[name] * _PROBE + idx).expand(t.shape).clone()
            elif t.is_floating_point():
                probe[name] = torch.full(t.shape, -1.0)
            else:
                probe[name] = t.detach().cpu()
        for leaf in _leaves(to_jax(probe)):
            leaf = np.asarray(leaf, np.float64)
            if leaf.ndim == 0 or leaf.size == 0 or leaf.min() < 0:
                continue
            i = int(leaf.flat[0]) // _PROBE
            rest = leaf - i * _PROBE
            if (
                i < len(names)
                and np.array_equal(rest, np.broadcast_to(np.arange(leaf.shape[-1]), leaf.shape))
                and param_sharding_spec(leaf.shape, mesh, min_size)
            ):
                split[names[i]] = d
    return split


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def replicate(fn, devices: Sequence[torch.device]) -> Dict[torch.device, Callable]:
    """One callable per distinct device of ``devices``: ``fn`` itself where
    it is bound to that device (its ``device`` attribute) or where every
    entry is one device; elsewhere ``fn.on_device(device)``, a copy of
    ``fn`` bound to that device (the port's serving forwards carry one).
    A ``Mapping`` of device -> callable is taken as it is.  Raises where a
    device has no callable: a shard never runs on a device other than its
    own."""
    devices = [canonical_device(d) for d in devices]
    if isinstance(fn, Mapping):
        table = {canonical_device(d): f for d, f in fn.items()}
        missing = [str(d) for d in devices if d not in table]
        if missing:
            raise ValueError(f"no callable for devices {missing}")
        return table
    home = getattr(fn, "device", None)
    home = None if home is None else canonical_device(home)
    out: Dict[torch.device, Callable] = {}
    for d in devices:
        if d in out:
            continue
        if d == home or (home is None and len(set(devices)) == 1):
            out[d] = fn
        elif hasattr(fn, "on_device"):
            out[d] = fn.on_device(d)
        else:
            raise ValueError(
                f"{fn!r} cannot be replicated onto {d}: give a mapping of device -> "
                f"callable, or a serving forward (compile_serving_apply)"
            )
    return out


def gather(pieces: Sequence[torch.Tensor], device, dim: int = 1) -> torch.Tensor:
    """Concatenate per-device pieces along ``dim`` on ``device``."""
    dev = canonical_device(device)
    return torch.cat([p.to(dev, non_blocking=True) for p in pieces], dim=dim)
