"""PyTorch port, NSGA-II and ``fit_Q_SCA(pareto=True)`` against JAX (CPU,
float64).

``rrmpg_tpu_torch.tools.moo`` holds ``rrmpg_tpu.tools.moo``'s
``ParetoResult``, ``nsga2`` (JAX's parameters in its order, then
``device`` and ``dtype``) and ``hypervolume_2d``.  ``_dominance``,
``_nondominated_ranks`` and ``hypervolume_2d`` equal JAX's exactly, on
random objective vectors with ties, NaN and inf rows.  ``crowding`` (a
closure in the JAX package, lifted to module level) equals a plain numpy
Deb crowding written here: per-front normalization, inf at the
boundaries, ties in index order as ``jnp.lexsort`` orders them.  The
random streams differ, so ``nsga2`` is held to the JAX tests' bounds on
ZDT1 and to its own determinism.

``fit_Q_SCA(pareto=True)`` returns a ``ParetoResult`` on both hysteresis
classes and both engines; its front re-evaluates to its ``f``.  The
``(L_q, L_sca)`` components of the fused objective (here K8's plain
version) equal JAX's ``q_sca_components_from_stats`` of the same
statistics at ``rtol=1e-12`` and the JAX trajectory losses at
``rtol=1e-8``; the ``'scan'`` components equal JAX's XLA losses at
``rtol=1e-9``.  The slow test holds them to JAX's Pallas statistics in
interpret mode at ``rtol=1e-9``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import compositions as jax_comp
from rrmpg_tpu.ops import pallas_snow as jax_snow
from rrmpg_tpu.tools import moo as jax_moo
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.tools import ParetoResult, hypervolume_2d, nsga2
from rrmpg_tpu_torch.tools import moo

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
ALTITUDES = [550, 620, 700, 785, 920]
FRAC_ICE = np.array([0.02, 0.04, 0.25, 0.51, 0.71])


def zdt1(x):
    f1 = x[0]
    g = 1.0 + 9.0 * torch.mean(x[1:])
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g))])


def zdt1_batched(X):
    f1 = X[:, 0]
    g = 1.0 + 9.0 * X[:, 1:].mean(dim=1)
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g))], dim=1)


def _objectives(seed, n=40, m=2):
    """Random objective vectors on a coarse grid (many ties and mutually
    dominated members), with NaN and inf rows."""
    rng = np.random.default_rng(seed)
    F = rng.integers(0, 6, (n, m)).astype(np.float64)
    F[3, 0] = np.nan
    F[7] = np.inf
    F[11, m - 1] = -np.inf
    F[19] = np.nan
    return F


@pytest.mark.parametrize("seed,m", [(0, 2), (1, 2), (2, 3)])
def test_dominance_and_ranks_match_jax(seed, m):
    F = _objectives(seed, m=m)
    np.testing.assert_array_equal(
        moo._dominance(torch.tensor(F)).numpy(),
        np.asarray(jax_moo._dominance(jnp.asarray(F))))
    np.testing.assert_array_equal(
        moo._nondominated_ranks(torch.tensor(F)).numpy(),
        np.asarray(jax_moo._nondominated_ranks(jnp.asarray(F))))


def test_building_blocks_analytic():
    F = torch.tensor([[0.0, 3.0], [3.0, 0.0], [1.0, 4.0], [4.0, 1.0],
                      [5.0, 5.0]], dtype=F64)
    np.testing.assert_array_equal(moo._nondominated_ranks(F).numpy(),
                                  [0, 0, 1, 1, 2])
    dom = moo._dominance(torch.tensor([[1.0, 1.0], [np.nan, 0.0],
                                       [np.inf, 2.0]])).numpy()
    assert not dom[1].any() and not dom[2].any()
    assert dom[0, 1] and dom[0, 2]


def _crowding_numpy(F, ranks):
    """Deb's crowding distance, one front at a time."""
    Fs = np.where(np.isfinite(F), F, np.inf)
    total = np.zeros(len(F))
    for j in range(F.shape[1]):
        col = Fs[:, j]
        for r in np.unique(ranks):
            members = np.flatnonzero(ranks == r)
            order = members[np.argsort(col[members], kind="stable")]
            span = col[order].max() - col[order].min()
            for k, i in enumerate(order):
                if k == 0 or k == len(order) - 1:
                    total[i] += np.inf
                    continue
                with np.errstate(invalid="ignore"):
                    gap = ((col[order[k + 1]] - col[order[k - 1]]) / span
                           if np.isfinite(span) and span > 0 else 0.0)
                total[i] += np.inf if np.isnan(gap) else gap
    return total


@pytest.mark.parametrize("seed,m", [(0, 2), (3, 2), (4, 3)])
def test_crowding_matches_deb(seed, m):
    F = _objectives(seed, m=m)
    F[F == 5] += np.random.default_rng(seed).uniform(0, 1, (F == 5).sum())
    ranks = moo._nondominated_ranks(torch.tensor(F))
    got = moo.crowding(torch.tensor(F), ranks).numpy()
    want = _crowding_numpy(F, ranks.numpy())
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hypervolume_matches_jax(seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 1.2, (30, 2))
    f[4] = np.nan
    f[9, 1] = np.inf
    ref = [1.0, 1.1]
    assert hypervolume_2d(f, ref) == jax_moo.hypervolume_2d(f, ref)


def test_hypervolume_exact_areas():
    assert hypervolume_2d([[0.0, 0.0]], [1.0, 1.0]) == 1.0
    assert hypervolume_2d([[0.0, 0.5], [0.5, 0.0], [0.6, 0.6],
                           [2.0, -1.0], [np.nan, 0.0]], [1.0, 1.0]) == 0.75
    assert hypervolume_2d([[2.0, 2.0]], [1.0, 1.0]) == 0.0
    with pytest.raises(ValueError):
        hypervolume_2d([[0.0, 0.0, 0.0]], [1.0, 1.0])


def test_zdt1_convex_front():
    res = nsga2(zdt1, [(0.0, 1.0)] * 10, pop_size=100, n_generations=150,
                seed=0, **CPU)
    f = res.f
    assert np.abs(f[:, 1] - (1.0 - np.sqrt(f[:, 0]))).mean() < 0.01
    assert f[:, 0].min() < 0.05 and f[:, 0].max() > 0.95
    assert res.nfev == 100 * 151
    assert not moo._dominance(torch.tensor(f)).any()
    assert (res.rank[res.rank == 0].size == len(f))


def test_deterministic_and_batched():
    r1 = nsga2(zdt1, [(0.0, 1.0)] * 4, pop_size=32, n_generations=20,
               seed=3, **CPU)
    r2 = nsga2(zdt1, [(0.0, 1.0)] * 4, pop_size=32, n_generations=20,
               seed=3, **CPU)
    np.testing.assert_array_equal(r1.population, r2.population)
    r3 = nsga2(zdt1_batched, [(0.0, 1.0)] * 4, pop_size=32,
               n_generations=20, seed=3, batched=True, **CPU)
    np.testing.assert_allclose(r3.population, r1.population, rtol=1e-12)


def test_carried_ranks_are_the_population_ranks():
    """A generation keeps the ranks of its survivors from the 2P pool:
    they equal a fresh ranking of the kept population."""
    res = nsga2(zdt1, [(0.0, 1.0)] * 4, pop_size=32, n_generations=7,
                seed=5, **CPU)
    fresh = moo._nondominated_ranks(torch.tensor(res.population_f))
    np.testing.assert_array_equal(res.rank, fresh.numpy())


def test_bounds_respected_and_odd_popsize():
    res = nsga2(zdt1, [(0.2, 0.9)] * 3, pop_size=33, n_generations=10,
                seed=0, **CPU)
    assert res.population.shape == (34, 3)
    assert (res.population >= 0.2 - 1e-12).all()
    assert (res.population <= 0.9 + 1e-12).all()


def test_nonfinite_objectives_never_on_front():
    def guarded(x):
        return torch.where(x[0] > 0.5, torch.nan, zdt1(x))

    res = nsga2(guarded, [(0.0, 1.0)] * 4, pop_size=32, n_generations=30,
                seed=5, **CPU)
    assert np.isfinite(res.f).all()


def test_improves_over_generations():
    r_short = nsga2(zdt1, [(0.0, 1.0)] * 6, pop_size=48, n_generations=5,
                    seed=0, **CPU)
    r_long = nsga2(zdt1, [(0.0, 1.0)] * 6, pop_size=48, n_generations=60,
                   seed=0, **CPU)
    ref = [1.5, 10.0]
    assert hypervolume_2d(r_long.f, ref) > hypervolume_2d(r_short.f, ref)


def test_jax_key_raises():
    with pytest.raises(TypeError, match="torch.Generator"):
        nsga2(zdt1, [(0.0, 1.0)] * 2, n_generations=1,
              key=jax.random.PRNGKey(0), **CPU)


# ---------------------------------------------------------------------------
# fit_Q_SCA(pareto=True) on the two hysteresis classes
# ---------------------------------------------------------------------------

def _snow_case(ice, T=120, seed=0):
    rng = np.random.default_rng(seed)
    mean_t = rng.uniform(-8, 10, T)
    forcing = dict(prec=rng.gamma(0.8, 6.0, T), mean_temp=mean_t,
                   min_temp=mean_t - 3, max_temp=mean_t + 3,
                   etp=rng.uniform(0.5, 3, T))
    if ice:
        forcing['frac_ice'] = FRAC_ICE
    ndsi = {f'NDSI{i}': rng.uniform(0, 100, T) for i in range(1, 6)}
    qobs = rng.uniform(0.1, 3, T)
    return forcing, ndsi, qobs


def _q_sca_model(ice):
    cls = models.CemaneigeHystGR4JIce if ice else models.CemaneigeHystGR4J
    return cls(**CPU)


def _prepared(model, forcing, ndsi, ice):
    f = model._prepare(
        forcing['prec'], forcing['mean_temp'], forcing['min_temp'],
        forcing['max_temp'], forcing['etp'], FRAC_ICE if ice else None,
        495, ALTITUDES, 0, 0, 0, 0, 0,
        extra_series=tuple(ndsi.items()))
    return f, torch.stack(f.extras)


def _jax_q_sca_losses(model, forcing, ndsi, qobs, X, ice, loss_metric):
    """JAX's XLA (L_q, L_sca) of each candidate: its trajectories through
    its metrics, as its fit_Q_SCA(pareto=True, engine='xla') computes."""
    f, _ = _prepared(model, forcing, ndsi, ice)
    args = [jnp.asarray(t.numpy()) for t in (f.prec, f.mean_temp, f.etp)]
    if ice:
        args.append(jnp.asarray(FRAC_ICE))
    args.append(jnp.asarray(f.frac_solid_prec.numpy()))
    run = (jax_comp.run_cemaneigehystgr4jice if ice
           else jax_comp.run_cemaneigehystgr4j)
    loss = jax_metrics.calibration_loss(loss_metric)
    ndsi_j = jnp.stack([jnp.asarray(v) for v in ndsi.values()])
    qobs_j = jnp.asarray(qobs)

    @jax.jit
    @jax.vmap
    def losses(x):
        params = {n: x[i] for i, n in enumerate(model._param_list)}
        series = run(*args, 0.0, 0.0, 0.0, 0.0, 0.0, params)
        sca = 100.0 * series[5].T
        return jnp.stack([loss(qobs_j, series[0]),
                          sum(loss(ndsi_j[b], sca[b]) for b in range(5))])

    return np.asarray(losses(jnp.asarray(X)))


def _candidates(model, n, seed=1):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(*model._default_bounds[p], n)
                            for p in model._param_list])


@pytest.mark.parametrize("ice", [False, True], ids=["hyst", "hyst+ice"])
@pytest.mark.parametrize("loss_metric", ["mse", "kge"])
def test_fused_components_match_jax(ice, loss_metric):
    forcing, ndsi, qobs = _snow_case(ice)
    model = _q_sca_model(ice)
    f, nd = _prepared(model, forcing, ndsi, ice)
    qobs_t = torch.tensor(qobs)
    X = _candidates(model, 6)
    got = model._fused_q_sca_objective(loss_metric, f, qobs_t, nd,
                                       components=True)(torch.tensor(X))
    assert got.shape == (6, 2)
    stats = model._fused_objective_stats(
        f, qobs_t, model._candidates(torch.tensor(X)), ndsi=nd,
        sca_stats=True, masked=False)
    want = jax_snow.q_sca_components_from_stats(
        jnp.asarray(stats.numpy()), jnp.asarray(qobs),
        jnp.asarray(nd.numpy()), loss_metric)
    np.testing.assert_allclose(got.numpy(), np.stack(want, axis=1),
                               rtol=1e-12)
    xla = _jax_q_sca_losses(model, forcing, ndsi, qobs, X, ice, loss_metric)
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-8)
    blend = model._fused_q_sca_objective(loss_metric, f, qobs_t, nd)(
        torch.tensor(X))
    np.testing.assert_allclose(blend.numpy(),
                               0.75 * got[:, 0] + 0.05 * got[:, 1],
                               rtol=1e-14)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("ice", [False, True], ids=["hyst", "hyst+ice"])
def test_fit_q_sca_pareto(ice, engine):
    forcing, ndsi, qobs = _snow_case(ice)
    model = _q_sca_model(ice)
    res = model.fit_Q_SCA(qobs, **forcing, **ndsi, met_station_height=495,
                          altitudes=ALTITUDES, seed=0, pareto=True,
                          engine=engine, pop_size=8, n_generations=2)
    assert isinstance(res, ParetoResult)
    assert res.population.shape == (8, len(model._param_list))
    assert res.f.shape[1] == 2 and res.x.shape[0] >= 1
    assert np.isfinite(res.f).all() and (res.rank[res.rank == 0].size
                                         == len(res.x))
    assert res.nfev == 8 * 3
    # The front re-evaluates to its f: JAX's XLA losses of its members.
    want = _jax_q_sca_losses(model, forcing, ndsi, qobs, res.x, ice, 'mse')
    np.testing.assert_allclose(res.f, want, rtol=1e-8 if engine == "fused"
                               else 1e-9)


def test_fit_q_sca_pareto_with_initial_state_raises():
    forcing, ndsi, qobs = _snow_case(False, T=40)
    model = models.CemaneigeHystGR4J(**CPU)
    kw = dict(met_station_height=495, altitudes=ALTITUDES)
    _, state = model.simulate(**forcing, **kw, return_final_state=True)
    with pytest.raises(ValueError, match="cold starts only"):
        model.fit_Q_SCA(qobs, **forcing, **ndsi, **kw, initial_state=state,
                        pareto=True, n_generations=1)


@pytest.mark.slow
def test_fused_components_match_jax_pallas_statistics():
    """The fused components equal JAX's ``q_sca_components_from_stats`` of
    JAX's own SCA statistics (its Pallas kernel in interpret mode)."""
    forcing, ndsi, qobs = _snow_case(False, T=96)
    model = _q_sca_model(False)
    f, nd = _prepared(model, forcing, ndsi, False)
    X = _candidates(model, 8)
    for loss_metric in ("mse", "kge"):
        got = model._fused_q_sca_objective(loss_metric, f, torch.tensor(qobs),
                                           nd, components=True)(
                                               torch.tensor(X)).numpy()
        from rrmpg_tpu.models import gr4j as jax_gr4j
        n1, n2 = jax_gr4j.fit_uh_lengths(model._default_bounds['x4'][1])
        stats = jax_snow.snowgr4j_ensemble_mse_pallas(
            f.prec.numpy(), f.mean_temp.numpy(), f.etp.numpy(),
            f.frac_solid_prec.numpy(), qobs, 0.0, 0.0, 0.0, 0.0,
            {n: X[:, i] for i, n in enumerate(model._param_list)},
            ndsi=nd.numpy(), hyst=True, ice=False, sca_stats=True,
            num_uh1=n1, num_uh2=n2, interpret=True)
        want = jax_snow.q_sca_components_from_stats(
            stats, jnp.asarray(qobs), jnp.asarray(nd.numpy()), loss_metric)
        np.testing.assert_allclose(got, np.stack(want, axis=1), rtol=1e-9)


@pytest.mark.slow
def test_zdt2_nonconvex_front():
    def zdt2(x):
        f1 = x[0]
        g = 1.0 + 9.0 * torch.mean(x[1:])
        return torch.stack([f1, g * (1.0 - (f1 / g) ** 2)])

    res = nsga2(zdt2, [(0.0, 1.0)] * 10, pop_size=100, n_generations=200,
                seed=1, **CPU)
    f = res.f
    assert np.abs(f[:, 1] - (1.0 - f[:, 0] ** 2)).mean() < 0.02
    assert ((f[:, 0] > 0.2) & (f[:, 0] < 0.8)).sum() > 10


@pytest.mark.slow
def test_fit_q_sca_pareto_larger_front():
    forcing, ndsi, qobs = _snow_case(True, T=150)
    res = _q_sca_model(True).fit_Q_SCA(
        qobs, **forcing, **ndsi, met_station_height=495, altitudes=ALTITUDES,
        seed=0, pareto=True, engine='fused', pop_size=16, n_generations=5)
    assert isinstance(res, ParetoResult) and np.isfinite(res.f).all()


@pytest.mark.slow
def test_gr4j_highflow_vs_lowflow_tradeoff():
    from rrmpg_tpu_torch.ops import run_gr4j
    from rrmpg_tpu_torch.utils import mse

    rng = np.random.default_rng(0)
    T = 400
    prec = torch.tensor(rng.gamma(0.7, 7.0, T))
    etp = torch.tensor(rng.uniform(1, 4, T))
    truth = {k: torch.tensor([v], dtype=F64) for k, v in
             {'x1': 500.0, 'x2': -1.0, 'x3': 150.0, 'x4': 2.5}.items()}
    qobs = torch.clamp_min(run_gr4j(prec * 1.1, etp, 0.3, 0.4, truth)[0][0],
                           1e-3)

    def objectives(X):
        params = {k: X[:, j] for j, k in enumerate(('x1', 'x2', 'x3',
                                                    'x4'))}
        qsim = torch.clamp_min(run_gr4j(prec, etp, 0.3, 0.4, params, 3,
                                        7)[0], 1e-3)
        return torch.stack([mse(qobs[None], qsim),
                            mse(torch.log(qobs)[None], torch.log(qsim))],
                           dim=1)

    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
    res = nsga2(objectives, bounds, pop_size=64, n_generations=40, seed=0,
                batched=True, **CPU)
    f = res.f
    assert np.isfinite(f).all() and f.shape[0] >= 5
    i_hi, i_lo = int(np.argmin(f[:, 0])), int(np.argmin(f[:, 1]))
    assert i_hi != i_lo
    assert f[i_hi, 1] > f[i_lo, 1] and f[i_lo, 0] > f[i_hi, 0]
