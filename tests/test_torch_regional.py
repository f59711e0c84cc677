"""PyTorch port, the regional GR4J path against JAX (CPU).

On CPU tensors ``gr4j_regional_objective_fused`` runs the plain version of
K5 (all catchments in one time loop over C * N members).  These tests hold
the port's ``rrmpg_tpu_torch.parallel.regional`` to the JAX package's
``rrmpg_tpu.parallel.regional``: the objectives against
``engine='xla'`` for every loss metric, masked and unmasked, at
``rtol=1e-10`` in float64 (the same equations, summed in another order);
one small case against the Pallas kernel in interpret mode (C=2, T=220,
N=5, UH (3, 7)); the ragged masked case of ``tests/test_masked.py``
checked by hand against the valid-subset MSE (``rtol=1e-9``); the port's
``'scan'`` engine against its ``'fused'`` one (``rtol=1e-10``); and
``regional_run`` against JAX's, with shared and ensemble parameters.

Chosen divergence, pinned here: a masked catchment with no finite
observation raises ``ValueError`` naming it; JAX returns NaN there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import run_gr4j as jax_run_gr4j
from rrmpg_tpu.parallel import regional as jax_regional
from rrmpg_tpu_torch import interop
from rrmpg_tpu_torch.ops import _launch
from rrmpg_tpu_torch.ops import fused_gr4j as fg
from rrmpg_tpu_torch.ops import run_gr4j
from rrmpg_tpu_torch.parallel import (regional_gr4j_objective, regional_run,
                                      regional_snow_objective)

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

RTOL = 1e-10
METRICS = ("mse", "rmse", "nse", "kge")


def _inputs(C=3, T=200, N=6, seed=13, ragged=False, x4_hi=2.9):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    if ragged:
        qobs[0, T * 4 // 5:] = np.nan                       # shorter record
        qobs[1, rng.choice(T, 25, replace=False)] = np.nan  # gaps
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_hi, N)}
    return prec, etp, qobs, params


def _p64(params):
    return interop.params_from_numpy(params, device='cpu',
                                     dtype=torch.float64)


def _series(*arrays):
    return interop.regional_forcing_from_numpy(*arrays, device='cpu',
                                               dtype=torch.float64)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("metric", METRICS)
def test_objective_matches_jax_xla(metric, ragged):
    prec, etp, qobs, params = _inputs(ragged=ragged)
    want = np.asarray(jax_regional.regional_gr4j_objective(
        prec, etp, qobs, 0.3, 0.3, _jax_params(params), engine="xla",
        loss_metric=metric))
    got = regional_gr4j_objective(*_series(prec, etp, qobs), 0.3, 0.3,
                                  _p64(params), loss_metric=metric)
    assert got.shape == (3, 6) and got.dtype == torch.float64
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_masked_ragged_records_by_hand(engine):
    """The case of tests/test_masked.py: one record cut short, one with 25
    scattered gaps; each catchment normalized over its own valid steps."""
    rng = np.random.default_rng(6)
    C, T, N = 2, 220, 5
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    qobs[0, 180:] = np.nan
    qobs[1, rng.choice(T, 25, replace=False)] = np.nan
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N), 'x4': rng.uniform(1.1, 2.9, N)}
    losses = regional_gr4j_objective(*_series(prec, etp, qobs), 0.3, 0.3,
                                     _p64(params), engine=engine,
                                     num_uh1=3, num_uh2=7).numpy()
    assert np.isfinite(losses).all()
    for c in range(C):
        valid = np.isfinite(qobs[c])
        p = {k: float(v[2]) for k, v in params.items()}
        q = np.asarray(jax_run_gr4j(prec[c], etp[c], 0.3, 0.3, p)[0])
        want = np.mean((q[valid] - qobs[c][valid]) ** 2)
        np.testing.assert_allclose(losses[c, 2], want, rtol=1e-9)


@pytest.mark.parametrize("uh,stats,masked", [((3, 7), True, True),
                                             ((10, 21), False, False)],
                         ids=["uh37-stats-masked", "uh1021-mse"])
def test_matches_pallas_interpret(uh, stats, masked):
    """K5's plain version against the Pallas kernel itself (interpret
    mode): ragged and masked with the statistics behind 'kge' at UH (3,
    7), and the unmasked MSE at UH (10, 21)."""
    from rrmpg_tpu.ops.pallas_gr4j import gr4j_regional_mse_pallas

    prec, etp, qobs, params = _inputs(C=2, T=220, N=5, seed=6,
                                      ragged=masked, x4_hi=uh[0] - 0.1)
    want = np.asarray(gr4j_regional_mse_pallas(
        prec, etp, qobs, 0.3, 0.3, _jax_params(params), t_tile=128,
        num_uh1=uh[0], num_uh2=uh[1], interpret=True, masked=masked,
        stats=stats))
    got = fg.gr4j_regional_objective_fused(
        *_series(prec, etp, qobs), 0.3, 0.3, _p64(params), *uh,
        stats=stats, masked=masked)
    assert got.shape == ((4, 2, 5) if stats else (2, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_scan_engine_equals_fused(metric):
    prec, etp, qobs, params = _inputs(ragged=True, seed=21)
    args = (*_series(prec, etp, qobs), 0.3, 0.3, _p64(params))
    fused = regional_gr4j_objective(*args, loss_metric=metric)
    scan = regional_gr4j_objective(*args, loss_metric=metric,
                                   engine="scan")
    np.testing.assert_allclose(scan.numpy(), fused.numpy(), rtol=RTOL)


def test_stats_layout_and_mse_row():
    """(4, C, N) statistics, row 0 the MSE of the (C, N) mode; each
    catchment's row equals the single-catchment K1/K2 plain version on
    that catchment."""
    prec, etp, qobs, params = _inputs(ragged=True, seed=3)
    args = (*_series(prec, etp, qobs), 0.2, 0.4, _p64(params))
    stats = fg.gr4j_regional_objective_fused(*args, stats=True, masked=True)
    mse = fg.gr4j_regional_objective_fused(*args, masked=True)
    assert stats.shape == (4, 3, 6) and mse.shape == (3, 6)
    torch.testing.assert_close(stats[0], mse, rtol=0, atol=0)
    prec_t, etp_t, qobs_t = args[:3]
    for c in range(3):
        single = fg.gr4j_ensemble_mse_fused(
            prec_t[c], etp_t[c], qobs_t[c], 0.2, 0.4, _p64(params),
            stats=True, masked=True)
        torch.testing.assert_close(stats[:, c], single, rtol=1e-12, atol=0)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "ensemble"])
def test_regional_run_matches_jax(shared):
    rng = np.random.default_rng(1)
    prec, etp = rng.uniform(0, 15, (4, 120)), rng.uniform(0, 4, (4, 120))
    if shared:
        params = {'x1': 350.0, 'x2': 1.0, 'x3': 90.0, 'x4': 2.0}
        jax_params = params
    else:
        params = {'x1': rng.uniform(100, 1200, 6),
                  'x2': rng.uniform(-5, 3, 6),
                  'x3': rng.uniform(20, 300, 6),
                  'x4': rng.uniform(1.1, 2.9, 6)}
        jax_params = _jax_params(params)
        params = _p64(params)
    want = jax_regional.regional_run(
        lambda p, e, q: jax_run_gr4j(p, e, 0.2, 0.2, q), (prec, etp),
        jax_params)
    got = regional_run(lambda p, e, q: run_gr4j(p, e, 0.2, 0.2, q),
                       _series(prec, etp), params)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_all_nan_catchment_raises(engine):
    """Divergence from rrmpg_tpu, chosen on purpose: JAX gives NaN for a
    catchment with no valid observation; the port raises, naming it."""
    prec, etp, qobs, params = _inputs()
    qobs[1] = np.nan
    jax_losses = np.asarray(jax_regional.regional_gr4j_objective(
        prec, etp, qobs, 0.3, 0.3, _jax_params(params), engine="xla"))
    assert np.isnan(jax_losses[1]).all()
    with pytest.raises(ValueError, match="catchment 1 has no finite"):
        regional_gr4j_objective(*_series(prec, etp, qobs), 0.3, 0.3,
                                _p64(params), engine=engine)


def test_masked_none_detects_gaps_and_false_is_honoured():
    prec, etp, qobs, params = _inputs(ragged=True, seed=4)
    args = (*_series(prec, etp, qobs), 0.3, 0.3, _p64(params))
    detected = regional_gr4j_objective(*args)
    forced = regional_gr4j_objective(*args, masked=True)
    torch.testing.assert_close(detected, forced, rtol=0, atol=0)
    assert bool(torch.isfinite(detected).all())
    # masked=False is taken as given: the gapped catchments' losses are
    # NaN, as in the JAX kernel, the gap-free one is the unmasked loss.
    unmasked = regional_gr4j_objective(*args, masked=False)
    assert bool(torch.isnan(unmasked[:2]).all())
    torch.testing.assert_close(unmasked[2], detected[2], rtol=1e-12, atol=0)
    # Gap-free records: detection picks the unmasked kernel.
    full = _series(prec, etp, np.nan_to_num(qobs, nan=1.0))
    counts, masked = _launch.valid_counts(full[2], None)
    assert masked is False and counts.tolist() == [200.0] * 3


@pytest.mark.parametrize("call", ["gr4j", "snow", "run"])
def test_mesh_raises(call):
    """A mesh runs (tests/test_torch_parallel.py); a non-mesh object is
    refused by type, before any input is read."""
    prec, etp, qobs, params = _inputs()
    series = _series(prec, etp, qobs)
    with pytest.raises(TypeError, match="rrmpg_tpu_torch.parallel.Mesh"):
        if call == "gr4j":
            regional_gr4j_objective(*series, 0.3, 0.3, _p64(params),
                                    mesh=object())
        elif call == "snow":
            regional_snow_objective(None, None, None, None, None, 0, 0, 0,
                                    0, _p64(params), mesh=object())
        else:
            regional_run(lambda *a: a[0], series, _p64(params),
                         mesh=object())


def test_bad_metric_engine_and_shapes_raise():
    prec, etp, qobs, params = _inputs()
    series = _series(prec, etp, qobs)
    with pytest.raises(ValueError, match="Unsupported loss_metric"):
        regional_gr4j_objective(*series, 0.3, 0.3, _p64(params),
                                loss_metric="mae")
    with pytest.raises(ValueError, match="Unsupported engine"):
        regional_gr4j_objective(*series, 0.3, 0.3, _p64(params),
                                engine="xla")
    with pytest.raises(ValueError, match=r"\(C, T\)"):
        fg.gr4j_regional_objective_fused(series[0], series[1][:, :50],
                                         series[2], 0.3, 0.3, _p64(params))
    with pytest.raises(ValueError, match="UH register lengths"):
        fg.gr4j_regional_objective_fused(*series, 0.3, 0.3, _p64(params),
                                         4, 9)


def test_regional_forcing_from_numpy_checks_shapes():
    prec, etp, qobs, _ = _inputs()
    with pytest.raises(ValueError, match=r"one \(C, T\) shape"):
        interop.regional_forcing_from_numpy(prec, etp[:, :10], device='cpu')
    layers = np.ones((3, 200, 2))
    out = interop.regional_forcing_from_numpy(
        etp, qobs, layers=(layers, layers, layers), frac_ice=[0.1, 0.2],
        device='cpu', dtype=torch.float64)
    assert [tuple(x.shape) for x in out] == [(3, 200)] * 2 + [
        (3, 200, 2)] * 3 + [(2,)]
    with pytest.raises(ValueError, match="frac_ice must be"):
        interop.regional_forcing_from_numpy(
            etp, layers=(layers,) * 3, frac_ice=np.ones((2, 2)),
            device='cpu')
    with pytest.raises(ValueError, match=r"\(C, T, L\)"):
        interop.regional_forcing_from_numpy(
            etp, layers=(layers, layers, layers[:, :5]), device='cpu')
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        interop.regional_forcing_from_numpy(etp)


def test_arrays_follow_the_parameters_device_and_dtype():
    """Regional objectives take numpy series as they are, on the
    parameters' device and in their dtype."""
    prec, etp, qobs, params = _inputs(ragged=True)
    from_arrays = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3,
                                          _p64(params))
    from_tensors = regional_gr4j_objective(*_series(prec, etp, qobs), 0.3,
                                           0.3, _p64(params))
    assert from_arrays.dtype == torch.float64
    torch.testing.assert_close(from_arrays, from_tensors, rtol=0, atol=0)
