"""Sharded ensemble evaluation over a device mesh.

Counterpart of ``rrmpg_tpu/parallel/ensemble.py``: the parameter ensemble
is split over the mesh's ensemble axis, each shard runs the batched
simulation on its device, and the shards' outputs come back in member order
(:func:`~.mesh.sharded_call`).  The port's ops take (N,) parameters, so
``kernel`` is one of them (e.g. :func:`~..ops.gr4j.run_gr4j`), where JAX
vmaps a single-set kernel.
"""

import numpy as np
import torch

from .mesh import ENSEMBLE_AXIS, sharded_call, tree_leaves


def _forcing(a, like):
    """A float numpy array as a tensor on ``like``'s device and in its
    dtype (JAX's ``jnp.asarray``); anything else as it is."""
    if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return a


def ensemble_run(kernel, forcing_args, params, mesh,
                 axis_name=ENSEMBLE_AXIS, state=None):
    """Evaluate ``kernel`` over an ensemble, sharded across ``mesh``.

    Args:
        kernel: batched function ``kernel(*forcing_args, params_dict)``
            (``kernel(*forcing_args, state, params_dict)`` when ``state``
            is given) returning a tensor or a tuple (of tensors or state
            trees) with a leading member axis.
        forcing_args: tuple of shared inputs (tensors, numbers; float numpy
            arrays go to the parameters' device and dtype), copied to every
            shard's device.
        params: dict of (N,) parameter tensors.
        mesh: :class:`~.mesh.Mesh` with an ``axis_name`` axis.
        axis_name: mesh axis to shard the ensemble over.
        state: (optional) per-member state tree (forecast mode); every
            tensor carries a leading (N,) member axis and is sharded like
            the parameters.

    Returns:
        Tuple of outputs with leading member axis (N, ...), the padding
        (N rounded up to a multiple of the shard count by repeating member
        0) removed, including inside output trees (a final state).
    """
    like = tree_leaves(params)[0]
    forcing_args = tuple(_forcing(a, like) for a in forcing_args)
    n_forcing = len(forcing_args)
    if state is None:
        args, axes = (*forcing_args, params), (None,) * n_forcing + (
            axis_name,)
    else:
        args, axes = (*forcing_args, state, params), (None,) * n_forcing + (
            axis_name, axis_name)
    outputs = sharded_call(kernel, mesh, args, axes, (axis_name,))
    return outputs if isinstance(outputs, tuple) else (outputs,)


def ensemble_objective(kernel, forcing_args, params, qobs, mesh,
                       metric=None, axis_name=ENSEMBLE_AXIS):
    """Sharded ensemble simulation, per-member objective and global best.

    Args:
        kernel: batched function whose first output is qsim (N, T).
        forcing_args: shared inputs, as in :func:`ensemble_run`.
        params: dict of (N,) parameter tensors.
        qobs: (T,) observations (NaN marks a gap).
        mesh: device mesh.
        metric: callable ``(qobs, qsim (N, T)) -> (N,)`` losses; defaults
            to the masked MSE.

    Returns:
        (losses (N,), best_index, best_loss) as tensors on the parameters'
        device.
    """
    qsim = ensemble_run(kernel, forcing_args, params, mesh,
                        axis_name=axis_name)[0]
    qobs = torch.as_tensor(np.asarray(qobs) if not isinstance(
        qobs, torch.Tensor) else qobs, dtype=qsim.dtype, device=qsim.device)
    if metric is None:
        from ..utils.metrics import mse

        losses = mse(qobs[None, :], qsim, dim=1)
    else:
        losses = metric(qobs, qsim)
    best_idx = torch.argmin(losses)
    return losses, best_idx, losses[best_idx]
