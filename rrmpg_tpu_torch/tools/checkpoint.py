"""Checkpoint files and directories; state bundles between forecast cycles.

Counterpart of ``rrmpg_tpu/tools/checkpoint.py``: any flat dict of arrays
round-trips through a single ``.npz`` file with atomic replacement, or
through a ``torch.distributed.checkpoint`` directory (JAX's Orbax
directory: :func:`save_checkpoint_dcp` / :func:`load_checkpoint_dcp`, for
runs that span processes), and :func:`save_state` / :func:`load_state`
persist the class-level state bundles (:mod:`..models.states`) in a
``.npz`` file.  The keys are the
JAX package's (``snow.<field>``, ``gr4j.<field>``, the ``bundle`` and
``snow_bundle`` tags), so a state file written by either package loads in
the other.

Files hold numpy arrays; tensors are fetched to the host on the way in, and
:func:`load_state` returns bundles of numpy arrays, which
``simulate(initial_state=)`` / ``fit(initial_state=)`` put on the model's
device in its dtype.
"""

import os
import shutil
import tempfile
import warnings

import numpy as np
import torch

from ..models import states as _states
from ..ops.gr4j import GR4JState

_META_PREFIX = "__meta__"

_FLAT_BUNDLES = _states.FLAT_BUNDLES


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_checkpoint(path, state, metadata=None):
    """Atomically write a flat dict of arrays (+ scalar metadata) to disk.

    Args:
        path: target filename (conventionally ``*.npz``).
        state: dict mapping names to tensors / arrays / array-likes
            (tensors on the card are fetched to the host).
        metadata: (optional) dict of small scalars/strings stored alongside.
    """
    payload = {k: _to_numpy(v) for k, v in state.items()}
    for k, v in (metadata or {}).items():
        payload[_META_PREFIX + k] = np.asarray(v)

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path):
    """Load a checkpoint written by :func:`save_checkpoint`.

    Returns:
        dict of numpy arrays; metadata entries are returned under a
        ``'metadata'`` sub-dict.
    """
    with np.load(path, allow_pickle=False) as data:
        state = {}
        metadata = {}
        for k in data.files:
            if k.startswith(_META_PREFIX):
                metadata[k[len(_META_PREFIX):]] = data[k][()]
            else:
                state[k] = data[k]
    if metadata:
        state['metadata'] = metadata
    return state


def _in_group():
    """Whether this process belongs to an initialized process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _dcp_call(fn, state, path, group):
    """``fn`` (DCP's save or load) on ``state`` at ``path``; in one process
    without its warning that no process group is initialized."""
    with warnings.catch_warnings():
        if not group:
            warnings.filterwarnings(
                "ignore", message="torch.distributed is disabled")
        return fn(state, checkpoint_id=path, no_dist=not group)


def save_checkpoint_dcp(path, state):
    """Write a flat dict of arrays as a checkpoint directory with
    ``torch.distributed.checkpoint`` (DCP).

    Counterpart of ``rrmpg_tpu.tools.checkpoint.save_checkpoint_orbax``:
    with a process group (:func:`~..parallel.initialize`) every process
    calls it with the same ``state``, as Orbax's ``StandardCheckpointer``
    is called; DCP writes each array once and rank 0 commits.  Without a
    group it runs in one process.

    DCP writes into ``<path>.tmp`` beside the target; only a complete
    directory is renamed to ``path`` (an existing one goes to
    ``<path>.old`` for the moment of the swap, then away).  A save that
    fails part-way leaves the previous checkpoint at ``path``, never a mix
    of two generations; one cut off between the two renames leaves it at
    ``<path>.old`` and nothing at ``path``.

    Args:
        path: target checkpoint directory (created or replaced).
        state: dict mapping names to tensors / arrays / array-likes
            (tensors on the card are fetched to the host).
    """
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    group = _in_group()
    lead = not group or dist.get_rank() == 0
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
    if group:
        dist.barrier()
    _dcp_call(dcp.save, {k: torch.from_numpy(np.array(_to_numpy(v)))
                         for k, v in state.items()}, tmp, group)
    if lead:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.lexists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    if group:
        dist.barrier()


def load_checkpoint_dcp(path):
    """Load a checkpoint directory written by :func:`save_checkpoint_dcp`.

    Counterpart of ``rrmpg_tpu.tools.checkpoint.load_checkpoint_orbax``
    (without its ``abstract_state``: the arrays come back whole, as
    numpy); with a process group every process calls it.

    Returns:
        dict of numpy arrays.

    Raises:
        ValueError: if ``path`` holds no such checkpoint (an Orbax
            directory of ``rrmpg_tpu``, say).
    """
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise ValueError(
            f"{path!r} holds no torch.distributed.checkpoint directory "
            "(an Orbax checkpoint of rrmpg_tpu cannot be read here).")
    entries = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(m.size, dtype=m.properties.dtype)
             for k, m in entries.items()}
    _dcp_call(dcp.load, state, path, _in_group())
    return {k: v.numpy() for k, v in state.items()}


def save_state(path, state):
    """Persist a simulation state bundle between forecast cycles.

    Serializes any of the class-level bundles (:mod:`..models.states`,
    including the nested ``SnowGR4JState``) to the atomic-npz format,
    recording the bundle type so :func:`load_state` reconstructs the exact
    bundle to pass back as ``simulate(initial_state=)``.

    Args:
        path: target filename (conventionally ``*.npz``).
        state: a state bundle as returned by
            ``simulate(..., return_final_state=True)``.
    """
    cls_name = type(state).__name__
    if cls_name != "SnowGR4JState" and cls_name not in _FLAT_BUNDLES:
        raise TypeError(
            f"save_state expects a state bundle; got {cls_name}. "
            "For arbitrary dicts of arrays use save_checkpoint.")

    if cls_name == "SnowGR4JState":
        flat = {f"snow.{f}": v
                for f, v in zip(type(state.snow)._fields, state.snow)}
        flat.update({f"gr4j.{f}": v
                     for f, v in zip(GR4JState._fields, state.gr4j)})
        meta = {"bundle": cls_name,
                "snow_bundle": type(state.snow).__name__}
    else:
        flat = dict(zip(type(state)._fields, state))
        meta = {"bundle": cls_name}
    save_checkpoint(path, flat, metadata=meta)


def load_state(path):
    """Reconstruct a state bundle written by :func:`save_state` (of this
    package or of ``rrmpg_tpu``); its leaves are numpy arrays."""
    data = load_checkpoint(path)
    meta = data.pop("metadata", {})
    bundle = str(meta.get("bundle", ""))
    if bundle == "SnowGR4JState":
        snow_cls = _FLAT_BUNDLES[str(meta["snow_bundle"])]
        snow = snow_cls(*(data[f"snow.{f}"] for f in snow_cls._fields))
        gr4j = GR4JState(*(data[f"gr4j.{f}"] for f in GR4JState._fields))
        return _states.SnowGR4JState(snow=snow, gr4j=gr4j)
    if bundle in _FLAT_BUNDLES:
        cls = _FLAT_BUNDLES[bundle]
        return cls(*(data[f] for f in cls._fields))
    raise ValueError(
        f"{path!r} does not hold a state bundle (bundle tag "
        f"{bundle!r}); was it written by save_state?")
