"""Device meshes: ensemble and catchment splits across devices.

Counterpart of ``rrmpg_tpu/parallel/mesh.py``.  The framework's parallel
axes are *ensemble* (parameter sets) and *catchment* (regional runs); both
are embarrassingly parallel, so a split runs each device's block of members
or catchments on that device and puts the blocks together again.

JAX places one global array on a mesh and lets ``shard_map`` run a function
on every device's block.  The port has no global sharded array, so its
forms are its own:

* :class:`Mesh` holds an ndarray of ``torch.device`` (``devices``), its
  ``axis_names``, ``shape`` (axis name -> size, as JAX's ``mesh.shape``)
  and ``size``.  Each entry is one shard, and a device may stand in it more
  than once: ``default_mesh(['cpu'] * 8)`` is eight shards on the CPU (the
  port's counterpart of ``--xla_force_host_platform_device_count=8``), and
  four entries of ``cuda:0`` are four shards on one card.  ``processes``
  holds the rank that runs each shard: all 0 in one process; after
  :func:`~.distributed.initialize`, the meshes span every process's devices
  in rank order.
* :func:`shard_leading_axis` gives a list of per-shard trees, each on its
  shard's device (``None`` where another process runs the shard).
* :func:`replicate` gives a dict of copies, one per distinct device of this
  process, keyed by the device.
* :func:`sharded_call` is the one evaluator every sharded entry point
  shares, as JAX's share ``shard_map``: it pads a split axis to a multiple
  of its shard count, places every shard's inputs on its device before it
  launches any shard, launches every shard before it reads anything back,
  gathers the results in shard order onto the caller's device (across
  processes with ``all_gather_object``) and drops the padding.

A function run per shard gets its inputs on its shard's device and must
compute there: the model classes build their calibration objectives once
per device from :func:`replicate`'s copies.  JAX's ``relaxed_shard_map`` is
JAX-specific and has no counterpart.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..utils.tracing import span, sync, traced

ENSEMBLE_AXIS = "ensemble"
CATCHMENT_AXIS = "catchment"


class Mesh:
    """Devices arranged along named axes; each entry is one shard.

    Args:
        devices: an array-like of devices (``torch.device`` or strings), one
            dimension per axis name.
        axis_names: the names of the axes.
        processes: (optional) the rank that runs each shard, same shape as
            ``devices`` (default: all 0).
    """

    def __init__(self, devices, axis_names, processes=None):
        given = np.asarray(devices, dtype=object)
        if given.size == 0:
            raise ValueError("a mesh needs at least one device.")
        shape = given.shape
        self.devices = _object_array(
            [_device(d) for d in given.ravel()]).reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"{len(self.axis_names)} axis names for a "
                f"{self.devices.ndim}-D array of devices.")
        if processes is None:
            processes = np.zeros(shape, dtype=int)
        self.processes = np.asarray(processes, dtype=int).reshape(shape)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = self.devices.size

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def check_mesh(mesh):
    """Raise ``TypeError`` for anything but a :class:`Mesh` (None passes)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be None or a rrmpg_tpu_torch.parallel.Mesh (from "
            f"default_mesh or ensemble_catchment_mesh); got "
            f"{type(mesh).__name__}.")


def _device(d):
    """``d`` as a ``torch.device`` with an index where it is a card."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _local_devices(devices):
    """This process's devices: the given ones, else every visible GPU (the
    one ``initialize`` chose, with several processes).  Never the CPU
    unless it is asked for."""
    if devices is not None:
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("devices is empty.")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_mesh() takes every visible GPU, and "
            "torch.cuda.is_available() is False; pass devices=['cpu', ...] "
            "for a mesh of CPU shards.")
    if _world()[1] > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _world():
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _across_processes(local):
    """Every process's devices in rank order, and the rank of each."""
    rank, world = _world()
    if world == 1:
        return local, [0] * len(local)
    import torch.distributed as dist

    gathered = [None] * world
    dist.all_gather_object(gathered, [str(d) for d in local])
    devices, processes = [], []
    for r, names in enumerate(gathered):
        devices += [local[i] if r == rank else torch.device(name)
                    for i, name in enumerate(names)]
        processes += [r] * len(names)
    return devices, processes


def default_mesh(devices=None, axis_name=ENSEMBLE_AXIS):
    """A 1-D mesh over all (or the given) devices.

    Args:
        devices: this process's devices (default: every visible GPU; with
            no GPU it raises, naming ``devices=['cpu', ...]``).  A device
            may repeat: each entry is one shard.
        axis_name: the mesh axis (default ``'ensemble'``).
    """
    devices, processes = _across_processes(_local_devices(devices))
    return Mesh(_object_array(devices), (axis_name,), processes)


def ensemble_catchment_mesh(ensemble=None, catchment=1, devices=None):
    """A 2-D (ensemble, catchment) mesh.

    Args:
        ensemble: size of the ensemble axis (defaults to
            ``num_devices // catchment``).
        catchment: size of the catchment axis.
        devices: devices to use (defaults as in :func:`default_mesh`).
    """
    devices, processes = _across_processes(_local_devices(devices))
    if ensemble is None:
        ensemble = len(devices) // catchment
    n = ensemble * catchment
    if n < 1 or n > len(devices):
        raise ValueError(
            f"a {ensemble} x {catchment} mesh needs {n} devices; "
            f"{len(devices)} given.")
    return Mesh(_object_array(devices[:n]).reshape(ensemble, catchment),
                (ENSEMBLE_AXIS, CATCHMENT_AXIS),
                np.asarray(processes[:n]).reshape(ensemble, catchment))


def _object_array(items):
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Trees of tensors (dicts, tuples, lists, NamedTuples; other leaves pass)
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree``; other leaves unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree):
    """The tensors of ``tree``, in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _to(tree, device):
    return tree_map(lambda x: x.to(device, non_blocking=True), tree)


def _shard_device(mesh, index):
    """(device, rank) of the shard at ``index`` (axis name -> position);
    an axis not named is taken at position 0."""
    pos = tuple(index.get(a, 0) for a in mesh.axis_names)
    return mesh.devices[pos], int(mesh.processes[pos])


def shard_leading_axis(tree, mesh, axis_name=ENSEMBLE_AXIS):
    """Split every tensor of ``tree`` along its leading axis over the
    mesh's ``axis_name``: a list with one tree a shard, on its device
    (``None`` for a shard another process runs).  A leading size the axis
    does not divide raises ``ValueError``."""
    check_mesh(mesh)
    k = _axis_size(mesh, axis_name)
    n = _split_size([tree], [axis_name], axis_name)
    if n % k:
        raise ValueError(
            f"a leading axis of {n} does not divide into the {k} shards of "
            f"mesh axis {axis_name!r}.")
    rank, chunk = _world()[0], n // k
    out = []
    for i in range(k):
        device, owner = _shard_device(mesh, {axis_name: i})
        out.append(None if owner != rank else _to(
            tree_map(lambda x: x[i * chunk:(i + 1) * chunk], tree), device))
    return out


def replicate(tree, mesh):
    """A copy of ``tree`` on every distinct device of this process's
    shards: a dict keyed by the device (the tree itself where it already
    lies there)."""
    check_mesh(mesh)
    rank = _world()[0]
    copies = {}
    for device, owner in zip(mesh.devices.ravel(), mesh.processes.ravel()):
        if owner == rank and device not in copies:
            copies[device] = _to(tree, device)
    return copies


# ---------------------------------------------------------------------------
# The shared evaluator
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis_name):
    if axis_name not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {axis_name!r}; its axes are "
            f"{mesh.axis_names}.")
    return mesh.shape[axis_name]


def _split_size(args, in_axes, axis_name):
    """The one leading size of the tensors split over ``axis_name``."""
    sizes = {x.shape[0] for arg, a in zip(args, in_axes) if a == axis_name
             for x in tree_leaves(arg)}
    if len(sizes) != 1:
        raise ValueError(
            f"the tensors split over mesh axis {axis_name!r} must share "
            f"one leading size; got {sorted(sizes)}.")
    return sizes.pop()


def _pad(x, padded):
    """``x`` with its leading axis padded to ``padded`` by repeating its
    first entry, as JAX's ``ensemble_run`` pads."""
    n = x.shape[0]
    if padded == n:
        return x
    return torch.cat([x, x[:1].expand(padded - n, *x.shape[1:])])


@traced("mesh.call")
def sharded_call(fn, mesh, args, in_axes, out_axes, pad=True):
    """Run ``fn`` once per shard of ``mesh`` and put the results together.

    Args:
        fn: ``fn(*shard_args)`` -> a tensor or a tree of tensors whose
            leading dimensions follow ``out_axes``.
        mesh: a :class:`Mesh`.
        args: tuple of trees.
        in_axes: one entry per arg: a mesh axis name (the arg's tensors are
            split along their leading axis over that axis) or None (each
            shard gets a copy on its device; other leaves pass as they are).
        out_axes: the mesh axis of each leading dimension of every output
            tensor (None: not split), e.g. ``(ENSEMBLE_AXIS,)`` or
            ``(CATCHMENT_AXIS, ENSEMBLE_AXIS)``; every split axis appears.
        pad: pad a split axis to a multiple of its shard count by repeating
            its first entry and drop the padding from the outputs.  With
            ``pad=False`` a size the axis does not divide raises
            ``ValueError``, as ``shard_map`` does.

    Returns:
        ``fn``'s output tree with every split dimension whole again, on the
        device of the first split tensor of ``args``.  An axis of the mesh
        that no arg is split over runs at its first position only.

    Every shard's inputs are copied to its device before the first ``fn``
    runs, then each ``fn`` runs in the same order: a copy from one card to
    another runs on the source card's stream and would otherwise queue
    behind the kernels an earlier shard put there.

    Where spans are recorded, each shard's copies are a ``mesh.copy`` span
    and its ``fn`` a ``mesh.shard`` span (``device``, and ``shard``: its
    position in row-major order over the split axes), every ``mesh.copy``
    before the first ``mesh.shard``; the gather and the assembly one
    ``mesh.assemble`` span.
    """
    check_mesh(mesh)
    if len(args) != len(in_axes):
        raise ValueError(f"{len(args)} args but {len(in_axes)} in_axes.")
    for a in in_axes:
        if a is not None:
            _axis_size(mesh, a)
    split_axes = [a for a in mesh.axis_names if a in in_axes]
    if set(split_axes) != {a for a in out_axes if a is not None}:
        raise ValueError(
            f"out_axes {out_axes} must name every split axis "
            f"{split_axes} once.")
    sizes, chunks = {}, {}
    args = list(args)
    for a in split_axes:
        n, k = _split_size(args, in_axes, a), mesh.shape[a]
        padded = pad_to_multiple(n, k)
        if padded != n and not pad:
            raise ValueError(
                f"a leading axis of {n} does not divide into the {k} "
                f"shards of mesh axis {a!r}.")
        sizes[a], chunks[a] = n, padded // k
        for j, axis in enumerate(in_axes):
            if axis == a:
                args[j] = tree_map(lambda x: _pad(x, padded), args[j])
    home = next(x for arg, a in zip(args, in_axes) if a is not None
                for x in tree_leaves(arg)).device

    rank, world = _world()
    copies, placed, results = {}, [], {}
    grid = np.ndindex(*(mesh.shape[a] for a in split_axes))
    for shard, flat in enumerate(grid):
        index = dict(zip(split_axes, flat))
        device, owner = _shard_device(mesh, index)
        if owner != rank:
            continue
        with span("mesh.copy", device=str(device), shard=shard):
            if device not in copies:
                copies[device] = [None if a is not None else _to(arg, device)
                                  for arg, a in zip(args, in_axes)]
            shard_args = []
            for arg, a, copy in zip(args, in_axes, copies[device]):
                if a is None:
                    shard_args.append(copy)
                    continue
                lo, hi = index[a] * chunks[a], (index[a] + 1) * chunks[a]
                shard_args.append(_to(tree_map(lambda x: x[lo:hi], arg),
                                      device))
        placed.append((shard, flat, device, shard_args))
    for shard, flat, device, shard_args in placed:
        with span("mesh.shard", device=str(device), shard=shard):
            results[flat] = fn(*shard_args)
    with span("mesh.assemble"):
        if world > 1:
            results = _gather(results)

        template = next(iter(results.values()))
        blocks = {flat: tree_leaves(out) for flat, out in results.items()}

        def assemble(leaf, depth, flat):
            if depth == len(split_axes):
                return blocks[flat][leaf].to(home)
            a = split_axes[depth]
            parts = [assemble(leaf, depth + 1, flat + (i,))
                     for i in range(mesh.shape[a])]
            whole = torch.cat(parts, dim=out_axes.index(a))
            return whole.narrow(out_axes.index(a), 0, sizes[a])

        whole = [assemble(j, 0, ()) for j in range(len(blocks[next(iter(
            blocks))]))]
        it = iter(whole)
        return tree_map(lambda _: next(it), template)


def _gather(local):
    """Every process's shard results, on the host, merged by shard."""
    import torch.distributed as dist

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {
        flat: tree_map(lambda x: sync("mesh.gather", x.cpu), out)
        for flat, out in local.items()})
    merged = {}
    for part in gathered:
        merged.update(part)
    merged.update(local)
    return merged

