"""Regional (multi-catchment) execution.

Counterpart of ``rrmpg_tpu/parallel/regional.py``.  The catchment axis is a
batch dimension: :func:`regional_run` runs a single-catchment function over
stacked forcings, crossed with a parameter ensemble, and the regional
objectives sweep one (N,) parameter ensemble over C catchments in one
launch of the fused regional kernels (K5 for GR4J, K11 for the snow + GR4J
compositions), one loss per (catchment, member).

Axis layout, as in JAX: ``(C, ...)`` for shared parameters, ``(C, N, ...)``
for an ensemble of (N,) parameters; the objectives return (C, N).

Records of unequal length are NaN-padded in ``qobs`` (``load_basins(
join='outer')``); the objectives then mask, each catchment normalized over
its own valid count.  ``masked=None`` detects gaps on the host, in the same
read that checks every catchment for a finite observation (JAX detects with
``np.isnan`` on possibly traced observations); an explicit ``True`` /
``False`` is honoured.  A masked catchment with no finite observation
raises ``ValueError`` naming it.

On a 2-D (ensemble, catchment) mesh the catchments are split over
``catchment`` and the members over ``ensemble``, one launch of the fused
kernel per (catchment shard, member shard) on that shard's device
(:func:`~.mesh.sharded_call`); a C or N the mesh axis does not divide
raises, as JAX's ``shard_map`` does.  The valid counts are taken once, on
the whole record, before the shards launch.
"""

import numpy as np
import torch

from ..ops import fused_gr4j as _fg
from ..ops import fused_snow as _fs
from ..ops._launch import valid_counts
from ..ops.gr4j import run_gr4j
from ..ops.stats import losses_from_stats
from ..ops.uh import NUM_UH1, NUM_UH2
from ..utils.metrics import calibration_loss
from ..utils.tracing import span, traced
from .mesh import CATCHMENT_AXIS, ENSEMBLE_AXIS, check_mesh, sharded_call


def regional_run(kernel, forcings, params, mesh=None):
    """Run a single-catchment function over a batch of catchments.

    Args:
        kernel: ``kernel(*forcings_one_catchment, params)`` taking (N,)
            parameter tensors and returning a tensor or a tuple of
            tensors with a leading member axis (the port's ops, e.g.
            :func:`~..ops.gr4j.run_gr4j`).
        forcings: tuple of tensors with a leading catchment axis (C, ...).
        params: dict of scalars (shared parameters) or of (N,) tensors (a
            parameter ensemble crossed with every catchment).
        mesh: (optional) device mesh; the catchment axis (and the member
            axis, with an ensemble) are split over the mesh axes of those
            names that the mesh has.

    Returns:
        Tuple of outputs with leading axis C (shared params) or axes
        (C, N) (ensemble).
    """
    check_mesh(mesh)
    if not forcings or not all(isinstance(f, torch.Tensor)
                               for f in forcings):
        raise TypeError(
            "regional_run takes its forcings as tensors with a leading "
            "catchment axis (interop.regional_forcing_from_numpy makes "
            "them).")
    ref = forcings[0]
    ensemble = torch.as_tensor(next(iter(params.values()))).dim() > 0
    if not ensemble:
        # One member: the ops keep a member axis, removed again below.
        params = {k: torch.as_tensor(v, dtype=ref.dtype,
                                     device=ref.device).reshape(1)
                  for k, v in params.items()}

    def local(forcings, params):
        per_catchment = []
        for c in range(forcings[0].shape[0]):
            out = kernel(*(f[c] for f in forcings), params)
            per_catchment.append(out if isinstance(out, tuple) else (out,))
        return tuple(torch.stack(parts) for parts in zip(*per_catchment))

    if mesh is None:
        outputs = local(forcings, params)
    else:
        cat = CATCHMENT_AXIS if CATCHMENT_AXIS in mesh.shape else None
        ens = (ENSEMBLE_AXIS if ensemble and ENSEMBLE_AXIS in mesh.shape
               else None)
        outputs = sharded_call(local, mesh, (tuple(forcings), params),
                               (cat, ens), (cat, ens), pad=False)
    if not ensemble:
        outputs = tuple(o[:, 0] for o in outputs)
    return outputs


def _regional_loss(loss_metric):
    """Per-catchment minimization loss for the regional objectives."""
    if loss_metric not in ("mse", "rmse", "nse", "kge"):
        raise ValueError(
            f"Unsupported loss_metric {loss_metric!r}; supported: "
            "'mse', 'rmse', 'nse', 'kge'.")
    return calibration_loss(loss_metric)


def _losses_from_regional_stats(out, qobs, loss_metric):
    """A fused regional kernel's output -> (C, N) minimization losses: the
    (C, N) MSE or its root, or, from the (4, C, N) statistics, 'nse' and
    'kge' as ``1 - score``, each catchment against its own ``qobs``."""
    if loss_metric in ("mse", "rmse"):
        return torch.sqrt(out) if loss_metric == "rmse" else out
    return 1.0 - torch.stack([
        losses_from_stats(out[:, c], qobs[c])[loss_metric]
        for c in range(out.shape[1])])


def _series(x, like):
    """A tensor as it is; an array on ``like``'s device and in its dtype."""
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype,
                           device=like.device)


@traced("regional.objective")
def regional_gr4j_objective(prec, etp, qobs, s_init, r_init, params,
                            mesh=None, engine="fused", loss_metric="mse",
                            masked=None, num_uh1=NUM_UH1, num_uh2=NUM_UH2):
    """(Catchment x member) GR4J objective sweep; returns (C, N) losses.

    The regional Monte-Carlo / calibration path.  ``engine='fused'`` is one
    launch of K5 (:func:`~..ops.fused_gr4j.gr4j_regional_objective_fused`):
    one number per (catchment, member) for 'mse' / 'rmse', four for the
    statistics behind 'nse' / 'kge'.  ``engine='scan'`` runs the sequential
    :func:`~..ops.gr4j.run_gr4j` per catchment and the port's masked
    metrics, which drop gap steps as the kernel does, so both engines agree
    (JAX's ``'pallas'`` / ``'xla'``).

    Args:
        prec, etp, qobs: (C, T) per-catchment series: tensors, or arrays,
            which go to the parameters' device and dtype.
        s_init, r_init: scalar GR4J store initializations.
        params: dict of (N,) parameter tensors, shared across catchments.
        mesh: (optional) 2-D (ensemble, catchment) mesh.
        loss_metric: 'mse' (default), 'rmse', or 'nse' / 'kge' minimizing
            ``1 - score`` per catchment.
        masked: NaN observations are gaps: None (default) detects them,
            True / False is honoured by the fused engine.
        num_uh1, num_uh2: UH register lengths (the fused engine's are
            :data:`~..ops.fused_gr4j.SUPPORTED_UH`).
    """
    check_mesh(mesh)
    loss = _regional_loss(loss_metric)
    if engine not in ("fused", "scan"):
        raise ValueError(
            f"Unsupported engine {engine!r}; use 'scan' or 'fused'.")
    like = params['x1']
    prec, etp, qobs = (_series(a, like) for a in (prec, etp, qobs))
    # One read for the whole record; an all-NaN catchment raises.
    with span("regional.counts"):
        counts, masked = valid_counts(qobs, masked)

    def local(prec, etp, qobs, counts, params):
        if engine == "fused":
            out = _fg.gr4j_regional_objective_fused(
                prec, etp, qobs, s_init, r_init, params, num_uh1, num_uh2,
                stats=loss_metric in ("nse", "kge"), masked=masked,
                counts=counts)
            return _losses_from_regional_stats(out, qobs, loss_metric)
        return torch.stack([
            loss(qobs[c][None, :],
                 run_gr4j(prec[c], etp[c], s_init, r_init, params, num_uh1,
                          num_uh2)[0])
            for c in range(prec.shape[0])])

    return _regional_call(local, mesh, (prec, etp, qobs, counts), params)


@traced("regional.objective")
def regional_snow_objective(prec, mean_temp, etp, frac_solid_prec, qobs,
                            snow_pack_init, thermal_state_init, s_init,
                            r_init, params, frac_ice=None, hyst=False,
                            ice=False, mesh=None, loss_metric="mse",
                            masked=None, num_uh1=NUM_UH1, num_uh2=NUM_UH2):
    """(Catchment x member) coupled snow + GR4J sweep -> (C, N) losses.

    The snow-family counterpart of :func:`regional_gr4j_objective`: one
    launch of K11 (:func:`~..ops.fused_snow.snowgr4j_regional_mse_fused`),
    per-catchment layer forcing, snow thresholds (from each catchment's own
    series) and glacier fractions.

    Args:
        prec, mean_temp, frac_solid_prec: (C, T, L) layer forcing.
        etp, qobs: (C, T) series (tensors, or arrays, which go to the
            parameters' device and dtype, as the layer forcing does).
        snow_pack_init, thermal_state_init, s_init, r_init: scalar inits.
        params: dict of (N,) member parameter tensors.
        frac_ice: (L,) shared or (C, L) per-catchment glacier fractions.
        hyst, ice: composition variant selectors.
        mesh: (optional) 2-D (ensemble, catchment) mesh; a (C, L)
            ``frac_ice`` is split with its catchments.
        loss_metric: 'mse' (default), 'rmse', or 'nse' / 'kge' minimizing
            ``1 - score`` per catchment.
        masked: as in :func:`regional_gr4j_objective`.
    """
    check_mesh(mesh)
    _regional_loss(loss_metric)
    like = params['x1']
    prec, mean_temp, etp, frac_solid_prec, qobs = (
        _series(a, like)
        for a in (prec, mean_temp, etp, frac_solid_prec, qobs))
    catchment_series = [prec, mean_temp, etp, frac_solid_prec, qobs]
    if frac_ice is not None:
        frac_ice = _series(frac_ice, like)
        if mesh is not None and frac_ice.dim() == 1:
            frac_ice = frac_ice.expand(qobs.shape[0], -1).contiguous()
        catchment_series.append(frac_ice)
    with span("regional.counts"):
        counts, masked = valid_counts(qobs, masked)

    def local(*args):
        *series, counts, params = args
        prec, mean_temp, etp, frac_solid_prec, qobs, *fi = series
        out = _fs.snowgr4j_regional_mse_fused(
            prec, mean_temp, etp, frac_solid_prec, qobs, snow_pack_init,
            thermal_state_init, s_init, r_init, params,
            frac_ice=fi[0] if fi else None, hyst=hyst, ice=ice,
            stats=loss_metric in ("nse", "kge"), num_uh1=num_uh1,
            num_uh2=num_uh2, masked=masked, counts=counts)
        return _losses_from_regional_stats(out, qobs, loss_metric)

    return _regional_call(local, mesh, (*catchment_series, counts), params)


def _regional_call(local, mesh, catchment_args, params):
    """``local(*catchment_args, params)`` -> (C, N) losses: at once, or on
    a mesh one call per (catchment shard, member shard), catchments over
    ``catchment`` and members over ``ensemble`` (a 1-D mesh splits the
    one axis it has)."""
    if mesh is None:
        return local(*catchment_args, params)
    cat = CATCHMENT_AXIS if CATCHMENT_AXIS in mesh.shape else None
    ens = ENSEMBLE_AXIS if ENSEMBLE_AXIS in mesh.shape else None
    if cat is None and ens is None:
        raise ValueError(
            f"a regional mesh needs a {CATCHMENT_AXIS!r} or "
            f"{ENSEMBLE_AXIS!r} axis; got {mesh.axis_names}.")
    return sharded_call(local, mesh, (*catchment_args, params),
                        (cat,) * len(catchment_args) + (ens,), (cat, ens),
                        pad=False)
