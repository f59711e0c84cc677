"""PyTorch port, FDC signatures and the signature metrics of
``monte_carlo`` against JAX (CPU, float64).

``rrmpg_tpu_torch.utils.signatures`` holds the five functions of
``rrmpg_tpu.utils.signatures`` with ``dim`` for ``axis``.  Each equals
JAX's at ``rtol=1e-12`` on (T,) and (T, N) inputs (one sort and a few sums
on the same numbers), a NaN member and a constant series included:
``torch.sort`` puts NaN last as ``jnp.sort`` does, so a NaN trajectory (an
HBV-Edu member whose soil store went negative) gives NaN in both where
its NaN steps fall into the segment (FLV's low segment).

``monte_carlo(metrics=('mse', 'fhv', 'flv', 'fms'))`` after
``np.random.seed(s)`` draws JAX's members (both sample with the host numpy
generator) and equals JAX's result at ``rtol=1e-10``.  With a signature
metric, ``engine='fused', return_qsim=False`` goes through the trajectory
kernel (here its plain version), never the statistics kernel, and equals
the ``'scan'`` engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.models as jax_models
import rrmpg_tpu.utils.signatures as jax_sig
from rrmpg_tpu.tools import monte_carlo as jax_monte_carlo
from rrmpg_tpu_torch import models, utils
from rrmpg_tpu_torch.tools import monte_carlo
from rrmpg_tpu_torch.utils import signatures as sig

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
RTOL = 1e-12
MC_RTOL = 1e-10
SIGNATURES = ('fhv', 'flv', 'fms')
PAIR_FNS = {'fdc_fhv': {}, 'fdc_flv': {}, 'fdc_fms': {},
            'fdc_fhv-h': dict(h=0.1), 'fdc_flv-l': dict(l=0.5),
            'fdc_fms-band': dict(lower=0.1, upper=0.9)}


@pytest.fixture
def hydrograph():
    rng = np.random.default_rng(0)
    T = 1000
    base = rng.gamma(1.2, 2.0, T) + 0.1
    return np.sort(base)[::-1].copy()[rng.permutation(T)]


def _ensemble(hydrograph):
    """(T, 5) members: scaled, noisy, a NaN member, a constant series and
    a dry series (clipped at 1e-6 by FLV / FMS)."""
    rng = np.random.default_rng(1)
    T = len(hydrograph)
    nan_member = hydrograph * 1.3
    nan_member[T // 2:] = np.nan
    return np.stack([0.7 * hydrograph + 0.05,
                     hydrograph * rng.uniform(0.5, 1.5, T), nan_member,
                     np.full(T, 2.5), np.zeros(T)], axis=1)


def _assert_equal_nan_aware(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


@pytest.mark.parametrize("case", sorted(PAIR_FNS))
@pytest.mark.parametrize("shape", ["T", "TxN"])
def test_fdc_signature_matches_jax(hydrograph, case, shape):
    name, kw = case.split("-")[0], PAIR_FNS[case]
    if shape == "T":
        obs, sim, extra = hydrograph, hydrograph * 1.25 + 0.1, {}
        jax_kw = {}
    else:
        obs, sim = hydrograph[:, None], _ensemble(hydrograph)
        extra, jax_kw = dict(dim=0), dict(axis=0)
    got = getattr(sig, name)(torch.tensor(obs), torch.tensor(sim), **kw,
                             **extra)
    want = getattr(jax_sig, name)(jnp.asarray(obs), jnp.asarray(sim), **kw,
                                  **jax_kw)
    _assert_equal_nan_aware(got, want)


@pytest.mark.parametrize("shape", ["T", "TxN"])
def test_flashiness_and_runoff_ratio_match_jax(hydrograph, shape):
    q = hydrograph if shape == "T" else _ensemble(hydrograph)
    prec = np.random.default_rng(2).uniform(0, 10, q.shape)
    extra, jax_kw = ({}, {}) if shape == "T" else (dict(dim=0),
                                                   dict(axis=0))
    _assert_equal_nan_aware(sig.flashiness(torch.tensor(q), **extra),
                            jax_sig.flashiness(jnp.asarray(q), **jax_kw))
    _assert_equal_nan_aware(
        sig.runoff_ratio(torch.tensor(q), torch.tensor(prec), **extra),
        jax_sig.runoff_ratio(jnp.asarray(q), jnp.asarray(prec), **jax_kw))


def test_analytic_values(hydrograph):
    q = torch.tensor(hydrograph)
    assert abs(sig.fdc_fhv(q, q).item()) < 1e-4
    assert sig.fdc_fhv(q, 2 * q).item() == pytest.approx(100.0, abs=0.01)
    assert sig.fdc_fhv(q, 0.5 * q).item() == pytest.approx(-50.0, abs=0.01)
    assert abs(sig.fdc_flv(q, q).item()) < 1e-4
    assert abs(sig.fdc_fms(q, q).item()) < 1e-4
    med = q.median()
    assert sig.fdc_fms(q, torch.clamp_min(med + 0.3 * (q - med), 1e-3)) < -10
    assert sig.fdc_fms(q, torch.clamp_min(med + 2.5 * (q - med), 1e-3)) > 10
    assert sig.flashiness(torch.ones(100, dtype=F64)).item() == 0.0
    alt = torch.tensor(np.tile([0.0, 2.0], 50))
    assert sig.flashiness(alt).item() == pytest.approx(1.98, rel=1e-5)
    assert sig.runoff_ratio(torch.full((10,), 2.0, dtype=F64),
                            torch.full((10,), 5.0, dtype=F64)
                            ).item() == pytest.approx(0.4, rel=1e-6)


def test_only_top_segment_matters(hydrograph):
    q = np.sort(hydrograph)[::-1].copy()
    sim = q.copy()
    sim[20:] *= 0.5    # everything below the top-2 % cut (20/1000)
    assert abs(sig.fdc_fhv(torch.tensor(q), torch.tensor(sim)).item()) \
        < 1e-4


def test_hbv_nan_member_gives_jax_nan():
    """An HBV-Edu member whose soil store goes negative simulates to NaN;
    its signatures are NaN as JAX's, the other members' equal JAX's."""
    rng = np.random.default_rng(3)
    T = 400
    forcing = dict(temp=rng.uniform(-5, 20, T), prec=rng.uniform(0, 10, T),
                   month=rng.integers(1, 13, T), PE_m=rng.uniform(1, 4, 12),
                   T_m=rng.uniform(0, 15, 12))
    params = {k: rng.uniform(lo, hi, 4)
              for k, (lo, hi) in models.HBVEdu._default_bounds.items()}
    params['FC'][0] = 2.0
    qsim = models.HBVEdu(**CPU).simulate(
        **forcing, soil_init=100.0, params=params).numpy()   # (T, 4)
    assert np.isnan(qsim[:, 0]).any() and np.isfinite(qsim[:, 1:]).all()
    qobs = qsim[:, 1] * 1.1 + 0.05
    nan_seen = []
    for name in ('fdc_fhv', 'fdc_flv', 'fdc_fms'):
        got = getattr(sig, name)(torch.tensor(qobs[:, None]),
                                 torch.tensor(qsim), dim=0)
        want = getattr(jax_sig, name)(jnp.asarray(qobs[:, None]),
                                      jnp.asarray(qsim), axis=0)
        _assert_equal_nan_aware(got, want)
        nan_seen.append(np.isnan(got[0].item()))
    # NaN sorts last: the low segment holds the NaN steps.
    assert nan_seen[1]


def _gr4j_inputs(T=300, seed=4):
    rng = np.random.default_rng(seed)
    prec, etp = rng.gamma(0.8, 6.0, T), rng.uniform(1, 4, T)
    qobs = rng.gamma(1.0, 1.5, T) + 0.05
    return prec, etp, qobs


@pytest.mark.parametrize("seed", [0, 7])
def test_monte_carlo_signatures_match_jax(seed):
    prec, etp, qobs = _gr4j_inputs()
    metrics = ('mse',) + SIGNATURES
    np.random.seed(seed)
    got = monte_carlo(models.GR4J(**CPU), 24, qobs, metrics=metrics,
                      prec=prec, etp=etp)
    np.random.seed(seed)
    want = jax_monte_carlo(jax_models.GR4J(), 24, qobs, metrics=metrics,
                           prec=prec, etp=etp)
    np.testing.assert_array_equal(got['params'], want['params'])
    np.testing.assert_allclose(got['qsim'], want['qsim'], rtol=MC_RTOL)
    for m in metrics:
        assert got[m].shape == (24,)
        np.testing.assert_allclose(got[m], want[m], rtol=MC_RTOL)


def _class_case(name):
    rng = np.random.default_rng(5)
    T = 200
    if name == "GR4J":
        prec, etp, qobs = _gr4j_inputs(T)
        return models.GR4J(**CPU), qobs, dict(prec=prec, etp=etp)
    if name == "HBVEdu":
        kw = dict(temp=rng.uniform(-5, 20, T), prec=rng.uniform(0, 10, T),
                  month=rng.integers(1, 13, T), PE_m=rng.uniform(1, 4, 12),
                  T_m=rng.uniform(0, 15, 12), soil_init=100.0)
        return models.HBVEdu(**CPU), rng.uniform(0.1, 3, T), kw
    mean_t = rng.uniform(-8, 10, T)
    kw = dict(prec=rng.gamma(0.8, 6.0, T), mean_temp=mean_t,
              min_temp=mean_t - 3, max_temp=mean_t + 3,
              etp=rng.uniform(0.5, 3, T), met_station_height=495,
              altitudes=[550, 620, 700, 785, 920])
    return models.CemaneigeGR4J(**CPU), rng.uniform(0.1, 3, T), kw


@pytest.mark.parametrize("name", ["GR4J", "HBVEdu", "CemaneigeGR4J"])
def test_fused_branch_with_signatures_takes_the_trajectories(name,
                                                             monkeypatch):
    """A signature metric sends ``engine='fused', return_qsim=False`` to
    the trajectory kernel (K3 / K13 / K9), never to the statistics kernel,
    and the result equals the ``'scan'`` engine's."""
    model, qobs, kw = _class_case(name)
    metrics = ('mse', 'nse') + SIGNATURES

    def no_stats(*args, **kwargs):
        raise AssertionError("the statistics path cannot compute FDC "
                             "signatures")

    np.random.seed(11)
    want = monte_carlo(model, 16, qobs, metrics=metrics, engine='scan',
                       **kw)
    monkeypatch.setattr(model, "_fused_stats", no_stats)
    np.random.seed(11)
    got = monte_carlo(model, 16, qobs, metrics=metrics, engine='fused',
                      return_qsim=False, **kw)
    assert 'qsim' not in got
    np.testing.assert_array_equal(got['params'], want['params'])
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-8, atol=1e-12)


def test_fused_branch_without_signatures_keeps_the_statistics(monkeypatch):
    model, qobs, kw = _class_case("GR4J")
    called = []
    stats_fn = model._fused_stats
    monkeypatch.setattr(model, "_fused_stats",
                        lambda *a: called.append(1) or stats_fn(*a))
    monte_carlo(model, 8, qobs, metrics=('mse', 'kge'), engine='fused',
                return_qsim=False, **kw)
    assert called == [1]


def test_unknown_metric_still_raises():
    model, qobs, kw = _class_case("GR4J")
    with pytest.raises(ValueError, match="Unknown metric"):
        monte_carlo(model, 4, qobs, metrics=('fdc',), **kw)


@pytest.mark.parametrize("name", jax_sig.__all__)
def test_signature_names_export_from_utils(name):
    assert getattr(utils, name) is getattr(sig, name)
