"""PyTorch port, the regional snow + GR4J objective against JAX (CPU).

On CPU tensors ``snowgr4j_regional_mse_fused`` runs the plain version of
K11 (all catchments in one time loop over C * N members).  These tests
hold the port's ``regional_snow_objective`` to JAX's per-catchment XLA
compositions (``run_cemaneigegr4j``, ``run_cemaneigegr4jice``,
``run_cemaneigehystgr4j``, ``run_cemaneigehystgr4jice``, swept over
catchments and members by JAX's ``regional_run``, as
``tests/test_pallas_snow_regional.py`` does per pair): every variant, with
``frac_ice`` of shape (L,) and (C, L), every loss metric, and ragged masked
records, at ``rtol=1e-9`` in float64 (the same equations in another order,
over 250 steps of a branching recurrence).  One case runs the Pallas kernel
itself in interpret mode.  Each catchment's row also equals the
single-catchment K8 plain version on that catchment (``rtol=1e-12``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import compositions as jc
from rrmpg_tpu.parallel.regional import regional_run as jax_regional_run
from rrmpg_tpu_torch import interop
from rrmpg_tpu_torch.ops import fused_snow as fs
from rrmpg_tpu_torch.parallel import regional_snow_objective

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

RTOL = 1e-9
C, T, L, N = 2, 250, 3, 5
INITS = (2.0, -1.0, 0.2, 0.3)     # snow pack, thermal state, s, r
NAMES = ('CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4', 'DDF')
BOUNDS = ((0, 1), (0, 10), (1, 1000), (0, 1), (100, 1200), (-5, 3),
          (20, 300), (1.1, 2.9), (0, 30))
# (id, hyst, ice, frac_ice kind)
CASES = [("plain", False, False, None), ("hyst", True, False, None),
         ("ice-L", False, True, "L"), ("ice-CL", False, True, "CL"),
         ("hyst+ice-L", True, True, "L"), ("hyst+ice-CL", True, True, "CL")]
VARIANTS = {"plain": (False, False), "hyst": (True, False),
            "ice": (False, True), "hyst+ice": (True, True)}


@functools.lru_cache(maxsize=None)
def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    d = dict(prec=rng.uniform(0, 20, (C, T, L)),
             temp=rng.uniform(-10, 12, (C, T, L)),
             frac=rng.uniform(0, 1, (C, T, L)),
             etp=rng.uniform(0, 4, (C, T)), qobs=rng.uniform(0, 5, (C, T)),
             fi_cl=rng.uniform(0, 0.5, (C, L)), fi_l=rng.uniform(0, 0.5, L))
    ragged = d["qobs"].copy()
    ragged[0, 200:] = np.nan
    ragged[1, rng.choice(T, 20, replace=False)] = np.nan
    d["ragged"] = ragged
    d["params"] = {k: rng.uniform(lo, hi, N) for k, (lo, hi) in
                   zip(NAMES, BOUNDS)}
    return d


# JAX kernels of one catchment and member: (prec, temp, etp, frac, fi, p).
def _plain(pr, tm, et, fr, fi, p):
    return jc.run_cemaneigegr4j(pr, tm, et, fr, INITS[0], INITS[1],
                                INITS[2], INITS[3], p)[0]


def _hyst(pr, tm, et, fr, fi, p):
    return jc.run_cemaneigehystgr4j(pr, tm, et, fr, INITS[0], INITS[1], 0.0,
                                    INITS[2], INITS[3], p)[0]


def _ice(pr, tm, et, fr, fi, p):
    return jc.run_cemaneigegr4jice(pr, tm, et, fi, fr, INITS[0], INITS[1],
                                   INITS[2], INITS[3], p)[0]


def _hyst_ice(pr, tm, et, fr, fi, p):
    return jc.run_cemaneigehystgr4jice(pr, tm, et, fi, fr, INITS[0],
                                       INITS[1], 0.0, INITS[2], INITS[3],
                                       p)[0]


JAX_KERNELS = {(False, False): _plain, (True, False): _hyst,
               (False, True): _ice, (True, True): _hyst_ice}


def _frac_ice(kind):
    d = _inputs()
    return None if kind is None else (d["fi_l"] if kind == "L" else
                                      d["fi_cl"])


@functools.lru_cache(maxsize=None)
def _jax_qsim(hyst, ice, kind):
    """(C, N, T) discharge of every (catchment, member) pair from JAX."""
    d = _inputs()
    fi = np.broadcast_to(_frac_ice(kind) if ice else np.zeros(L), (C, L))
    (q,) = jax_regional_run(
        JAX_KERNELS[(hyst, ice)],
        (d["prec"], d["temp"], d["etp"], d["frac"], np.array(fi)),
        {k: jnp.asarray(v) for k, v in d["params"].items()})
    return np.asarray(q)


def _loss(metric, obs, sim):
    """Masked loss of one series, numpy: gaps in ``obs`` are dropped."""
    valid = np.isfinite(obs)
    o, s = obs[valid], sim[valid]
    if metric in ("mse", "rmse"):
        mse = np.mean((s - o) ** 2)
        return mse if metric == "mse" else np.sqrt(mse)
    if metric == "nse":
        return np.sum((s - o) ** 2) / np.sum((o - o.mean()) ** 2)
    r = np.corrcoef(o, s)[0, 1]
    alpha, beta = s.std() / o.std(), s.mean() / o.mean()
    return np.sqrt((r - 1) ** 2 + (alpha - 1) ** 2 + (beta - 1) ** 2)


def _want(metric, hyst, ice, kind, qobs):
    q = _jax_qsim(hyst, ice, kind)
    return np.array([[_loss(metric, qobs[c], q[c, i]) for i in range(N)]
                     for c in range(C)])


def _port(hyst, ice, kind, qobs, **kw):
    d = _inputs()
    etp, qo, prec, temp, frac, *fi = interop.regional_forcing_from_numpy(
        d["etp"], qobs, layers=(d["prec"], d["temp"], d["frac"]),
        frac_ice=_frac_ice(kind) if ice else None, device='cpu',
        dtype=torch.float64)
    params = interop.params_from_numpy(d["params"], device='cpu',
                                       dtype=torch.float64)
    return regional_snow_objective(
        prec, temp, etp, frac, qo, *INITS, params,
        frac_ice=fi[0] if fi else None, hyst=hyst, ice=ice, **kw)


@pytest.mark.parametrize("metric", ["mse", "rmse", "nse", "kge"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_compositions(case, metric):
    _, hyst, ice, kind = case
    got = _port(hyst, ice, kind, _inputs()["qobs"], loss_metric=metric)
    assert got.shape == (C, N) and got.dtype == torch.float64
    want = _want(metric, hyst, ice, kind, _inputs()["qobs"])
    # 'nse' / 'kge' are minimized as 1 - score; _loss gives 1 - NSE and
    # 1 - KGE directly.
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("metric", ["mse", "kge"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_masked_ragged_records(variant, metric):
    hyst, ice = VARIANTS[variant]
    kind = "CL" if ice else None
    ragged = _inputs()["ragged"]
    got = _port(hyst, ice, kind, ragged, loss_metric=metric).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _want(metric, hyst, ice, kind, ragged),
                               rtol=RTOL)


def test_matches_pallas_interpret():
    """K11's plain version against the Pallas kernel itself (interpret
    mode), the hysteresis + ice variant with (C, L) glacier fractions,
    ragged and masked (the only interpret-mode case: each compile takes
    tens of seconds)."""
    from rrmpg_tpu.ops.pallas_snow import snowgr4j_regional_mse_pallas

    rng = np.random.default_rng(9)
    c, t, layers, n = 2, 150, 2, 4
    prec = rng.uniform(0, 20, (c, t, layers))
    temp = rng.uniform(-10, 12, (c, t, layers))
    frac = rng.uniform(0, 1, (c, t, layers))
    etp = rng.uniform(0, 4, (c, t))
    qobs = rng.uniform(0, 5, (c, t))
    qobs[0, 120:] = np.nan
    qobs[1, rng.choice(t, 20, replace=False)] = np.nan
    fi = rng.uniform(0, 0.5, (c, layers))
    params = {k: rng.uniform(lo, hi, n) for k, (lo, hi) in
              zip(NAMES, BOUNDS)}
    want = np.asarray(snowgr4j_regional_mse_pallas(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2,
        {k: jnp.asarray(v) for k, v in params.items()}, frac_ice=fi,
        hyst=True, ice=True, t_tile=128, num_uh1=3, num_uh2=7,
        interpret=True, masked=True))
    etp_t, qobs_t, *layer_t, fi_t = interop.regional_forcing_from_numpy(
        etp, qobs, layers=(prec, temp, frac), frac_ice=fi, device='cpu',
        dtype=torch.float64)
    got = fs.snowgr4j_regional_mse_fused(
        layer_t[0], layer_t[1], etp_t, layer_t[2], qobs_t, 0.0, 0.0, 0.2,
        0.2, interop.params_from_numpy(params, device='cpu',
                                       dtype=torch.float64),
        frac_ice=fi_t, hyst=True, ice=True, num_uh1=3, num_uh2=7,
        masked=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_each_catchment_equals_single_catchment_k8(variant):
    """Row c of the (4, C, N) statistics is K8's plain version on catchment
    c alone: its own layer constants, glacier fractions and valid count."""
    hyst, ice = VARIANTS[variant]
    d = _inputs()
    etp, qobs, prec, temp, frac, fi = interop.regional_forcing_from_numpy(
        d["etp"], d["ragged"], layers=(d["prec"], d["temp"], d["frac"]),
        frac_ice=d["fi_cl"], device='cpu', dtype=torch.float64)
    params = interop.params_from_numpy(d["params"], device='cpu',
                                       dtype=torch.float64)
    kw = dict(hyst=hyst, ice=ice, stats=True, masked=True)
    stats = fs.snowgr4j_regional_mse_fused(
        prec, temp, etp, frac, qobs, *INITS, params,
        frac_ice=fi if ice else None, **kw)
    assert stats.shape == (4, C, N)
    for c in range(C):
        single = fs.snowgr4j_ensemble_mse_fused(
            prec[c], temp[c], etp[c], frac[c], qobs[c], *INITS, params,
            frac_ice=fi[c] if ice else None, **kw)
        torch.testing.assert_close(stats[:, c], single, rtol=1e-12, atol=0)


def test_layer_constants_come_from_each_catchment():
    """Changing catchment 1's forcing leaves catchment 0's losses as they
    were, bit for bit."""
    d = _inputs()
    layers = [d["prec"].copy(), d["temp"], d["frac"]]
    base = _port(True, False, None, d["qobs"])
    prec = layers[0]
    prec[1] *= 1.7
    etp, qobs, *lt = interop.regional_forcing_from_numpy(
        d["etp"], d["qobs"], layers=layers, device='cpu',
        dtype=torch.float64)
    params = interop.params_from_numpy(d["params"], device='cpu',
                                       dtype=torch.float64)
    changed = regional_snow_objective(lt[0], lt[1], etp, lt[2], qobs,
                                      *INITS, params, hyst=True)
    torch.testing.assert_close(changed[0], base[0], rtol=0, atol=0)
    assert not torch.allclose(changed[1], base[1])


@pytest.mark.parametrize("fault", ["no frac_ice", "frac_ice shape",
                                   "layer shape", "all-NaN catchment"])
def test_bad_inputs_raise(fault):
    d = _inputs()
    etp, qobs, prec, temp, frac, fi = interop.regional_forcing_from_numpy(
        d["etp"], d["qobs"], layers=(d["prec"], d["temp"], d["frac"]),
        frac_ice=d["fi_cl"], device='cpu', dtype=torch.float64)
    params = interop.params_from_numpy(d["params"], device='cpu',
                                       dtype=torch.float64)
    kw = dict(frac_ice=fi, ice=True)
    if fault == "no frac_ice":
        kw, match = dict(ice=True), "need 'frac_ice'"
    elif fault == "frac_ice shape":
        kw, match = dict(frac_ice=fi[:, :2], ice=True), "frac_ice must be"
    elif fault == "layer shape":
        temp, match = temp[:, :, :2].contiguous(), r"\(C, T, L\)"
    else:
        qobs = qobs.clone()
        qobs[1] = float("nan")
        match = "catchment 1 has no finite"
    with pytest.raises(ValueError, match=match):
        regional_snow_objective(prec, temp, etp, frac, qobs, *INITS, params,
                                **kw)


def test_masked_detection():
    """masked=None masks where qobs has a NaN; masked=False is honoured
    (NaN losses for the gapped catchments, as in the JAX kernel)."""
    ragged = _inputs()["ragged"]
    detected = _port(True, True, "CL", ragged)
    forced = _port(True, True, "CL", ragged, masked=True)
    torch.testing.assert_close(detected, forced, rtol=0, atol=0)
    assert bool(torch.isnan(_port(True, True, "CL", ragged,
                                  masked=False)).all())
