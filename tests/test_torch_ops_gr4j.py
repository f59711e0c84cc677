"""PyTorch port, plain GR4J ops against the JAX reference (CPU, float64).

Same inputs, drawn from a seeded numpy generator, go through
``rrmpg_tpu.ops`` and ``rrmpg_tpu_torch.ops``.  Tolerance: ``rtol=1e-10``
-- the two packages run the same float64 equations and differ only in
the order of a few sums (the UH filter is a convolution in JAX and a sum
of shifted slices here); measured differences are ~1e-13.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rrmpg_tpu.ops import gr4j as jax_gr4j
from rrmpg_tpu.ops import uh as jax_uh
from rrmpg_tpu_torch.interop import gr4j_state_from_numpy, params_from_numpy
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import gr4j as pt_gr4j
from rrmpg_tpu_torch.ops import uh as pt_uh

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

RTOL = 1e-10
DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
GOLDEN_PARAMS = {'x1': np.exp(5.76865628090826),
                 'x2': np.sinh(1.61742503661094),
                 'x3': np.exp(4.24316129943456),
                 'x4': np.exp(-0.117506799276908) + 0.5}


def _inputs(T, N, seed=0, x4_max=9.9):
    rng = np.random.default_rng(seed)
    forcing = {'prec': rng.uniform(0, 15, T), 'etp': rng.uniform(0, 4, T)}
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_max, N)}
    return forcing, params


def _p64(params):
    return params_from_numpy(params, device='cpu', dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _jax_run(forcing, params, s_init, r_init, n1=10, n2=21):
    fn = jax.vmap(lambda p: jax_gr4j.run_gr4j(
        forcing['prec'], forcing['etp'], s_init, r_init, p, n1, n2,
        return_final=True))
    qsim, s, r, final = fn({k: jnp.asarray(v) for k, v in params.items()})
    return qsim, s, r, final


def test_uh_ordinates_match_jax():
    x4 = np.random.default_rng(1).uniform(0.3, 9.9, 32)
    oh1, oh2 = pt_uh.uh_ordinates(_t(x4))
    for i, v in enumerate(x4):
        j1, j2 = jax_uh.uh_ordinates(jnp.float64(v))
        np.testing.assert_allclose(oh1[i].numpy(), np.asarray(j1),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(oh2[i].numpy(), np.asarray(j2),
                                   rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("n1,n2", [(3, 7), (10, 21)])
def test_causal_fir_matches_jax(n1, n2):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 3, (8, 50))
    taps = rng.uniform(0, 1, (8, n2))
    y = pt_uh.causal_fir(_t(x), _t(taps)).numpy()
    for i in range(8):
        np.testing.assert_allclose(
            y[i], np.asarray(jax_uh.causal_fir(jnp.asarray(x[i]),
                                               jnp.asarray(taps[i]))),
            rtol=1e-12, atol=1e-14)


def test_required_uh_lengths_match_jax():
    for x4 in ([1.5, 2.9], [10.0], [12.3, 4.0]):
        assert (pt_uh.required_uh_lengths(_t(x4))
                == jax_uh.required_uh_lengths(np.asarray(x4)))


@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
def test_run_gr4j_matches_jax(n1, n2, x4_max):
    forcing, params = _inputs(300, 64, seed=3, x4_max=x4_max)
    jq, js, jr, jfinal = _jax_run(forcing, params, 0.4, 0.3, n1, n2)
    q, s, r, final = pt_gr4j.run_gr4j(
        _t(forcing['prec']), _t(forcing['etp']), 0.4, 0.3,
        _p64(params), n1, n2,
        return_final=True)
    assert q.shape == (64, 300)
    for got, want in ((q, jq), (s, js), (r, jr), (final.s, jfinal.s),
                      (final.r, jfinal.r),
                      (final.pr_history, jfinal.pr_history)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-12)


def test_run_gr4j_warm_matches_jax_and_splits_exactly():
    forcing, params = _inputs(300, 16, seed=4)
    prec, etp = _t(forcing['prec']), _t(forcing['etp'])
    p = _p64(params)
    # JAX: first segment cold with its final state, second segment warm.
    _, _, _, jstate = _jax_run({k: v[:120] for k, v in forcing.items()},
                               params, 0.2, 0.5)
    jq_b = jax.vmap(lambda st, pp: jax_gr4j.run_gr4j_warm(
        forcing['prec'][120:], forcing['etp'][120:], st, pp)[0])(
            jstate, {k: jnp.asarray(v) for k, v in params.items()})
    state = gr4j_state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in jstate._fields},
        device='cpu', dtype=torch.float64)
    q_b, _, _, _ = pt_gr4j.run_gr4j_warm(prec[120:], etp[120:], state, p)
    np.testing.assert_allclose(q_b.numpy(), np.asarray(jq_b), rtol=RTOL,
                               atol=1e-12)
    # Port alone: cold head + warm tail == one uninterrupted run.
    q_full, _, _ = pt_gr4j.run_gr4j(prec, etp, 0.2, 0.5, p)
    q_a, _, _, st = pt_gr4j.run_gr4j(prec[:120], etp[:120], 0.2, 0.5, p,
                                     return_final=True)
    q_tail, _, _, _ = pt_gr4j.run_gr4j_warm(prec[120:], etp[120:], st, p)
    np.testing.assert_allclose(torch.cat([q_a, q_tail], 1).numpy(),
                               q_full.numpy(), rtol=1e-12, atol=1e-13)


def test_run_gr4j_warm_rejects_short_history():
    forcing, params = _inputs(20, 2, seed=5)
    state = pt_gr4j.GR4JState(s=_t([1.0, 1.0]), r=_t([1.0, 1.0]),
                              pr_history=torch.zeros(2, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="num_uh2"):
        pt_gr4j.run_gr4j_warm(_t(forcing['prec']), _t(forcing['etp']), state,
                              _p64(params))


@pytest.mark.parametrize("engine", ["ops", "scan", "fused"])
def test_golden_excel_trajectory(engine):
    data = pd.read_csv(os.path.join(DATA_DIR, 'gr4j_example_data.csv'))
    if engine == "ops":
        qsim, _, _ = pt_gr4j.run_gr4j(
            _t(data.prec), _t(data.etp), 0.6, 0.7,
            _p64(GOLDEN_PARAMS))
        qsim = qsim[0]
    else:
        model = GR4J(params=GOLDEN_PARAMS, dtype=torch.float64, device='cpu')
        qsim = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                              engine=engine)
        assert qsim.shape == (len(data), 1)
    assert np.allclose(qsim.numpy().ravel(), data.qsim_excel)
