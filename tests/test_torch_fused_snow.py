"""PyTorch port, the fused snow kernels' module against the JAX package
(CPU, float64).

On CPU tensors the wrappers of ``rrmpg_tpu_torch.ops.fused_snow`` run the
plain PyTorch versions of K8 / K9, written operation for operation like the
CUDA kernels.  The same numpy inputs go through them and through

* the Pallas kernels ``snowgr4j_ensemble_mse_pallas`` /
  ``snowgr4j_simulate_pallas`` (and their snow-only forms) in interpret
  mode, as the JAX package's own tests run them (``t_tile=64``):
  ``rtol=1e-9``, the same operations with time means formed as
  ``sum / T * (T / count)`` there and ``sum / count`` here;
* the XLA compositions (``vmap`` of ``rrmpg_tpu.ops.run_*``) and the port's
  own ``'scan'`` ops: ``rtol=1e-8``, because the kernel multiplies by a
  packed ``1/Thacc``, divides the layer sum by ``L`` and forms
  ``0.9 * (365.25 * mean)`` where the scan ops divide, take ``mean`` and form
  ``(0.9 * 365.25) * mean``.

The kernels themselves are tested on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.ops import compositions as jax_comp
from rrmpg_tpu.ops import pallas_snow as jax_snow
from rrmpg_tpu.utils import metrics as jax_metrics
from rrmpg_tpu_torch.interop import layer_forcing_from_numpy, params_from_numpy
from rrmpg_tpu_torch.ops import compositions, fused_snow
from rrmpg_tpu_torch.ops._launch import LAUNCHES, reset_launches
from rrmpg_tpu_torch.ops.stats import losses_from_stats

torch.set_num_threads(1)
pytestmark = pytest.mark.f64only

F64 = torch.float64
KERNEL_TOL = dict(rtol=1e-9, atol=1e-12)
ENGINE_TOL = dict(rtol=1e-8, atol=1e-11)
INITS = (2.0, -1.0, 0.4, 0.3)        # snow pack, thermal state, s, r
BOUNDS = {'CTG': (0, 1), 'Kf': (0, 10), 'Thacc': (1, 100), 'Rsp': (0, 1),
          'x1': (10, 1200), 'x2': (-5, 3), 'x3': (20, 5000),
          'x4': (1.1, 9.9), 'DDF': (0, 30)}
VARIANTS = {"plain": (False, False), "hyst": (True, False),
            "ice": (False, True), "hyst+ice": (True, True)}


class _Case:
    """One set of inputs as numpy (for JAX) and as CPU tensors."""

    def __init__(self, T=150, L=5, N=12, seed=0, gaps=False, x4_hi=9.9):
        rng = np.random.default_rng(seed)
        self.layers = (rng.uniform(0, 15, (T, L)),
                       rng.uniform(-12, 18, (T, L)),
                       np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
        self.etp = rng.uniform(0, 4, T)
        self.qobs = rng.uniform(1, 5, T)
        self.frac_ice = rng.uniform(0, 0.7, L)
        self.ndsi = rng.uniform(0, 100, (L, T))
        if gaps:
            self.qobs[::7] = np.nan
            self.qobs[20:33] = np.nan
            self.ndsi[0, ::5] = np.nan            # each band its own gaps
            self.ndsi[L - 1, 40:90] = np.nan
        self.params = {k: rng.uniform(lo, hi, N)
                       for k, (lo, hi) in BOUNDS.items()}
        self.params['x4'] = rng.uniform(1.1, x4_hi, N)
        (self.t_prec, self.t_temp, self.t_frac, self.t_frac_ice,
         self.t_ndsi) = layer_forcing_from_numpy(
            *self.layers, frac_ice=self.frac_ice, ndsi=self.ndsi,
            device='cpu', dtype=F64)
        self.t_etp, self.t_qobs = torch.tensor(self.etp), torch.tensor(
            self.qobs)
        self.t_params = params_from_numpy(self.params, device='cpu',
                                          dtype=F64)

    def pallas(self, fn, *series, **kw):
        """A Pallas wrapper on the numpy inputs, in interpret mode."""
        prec, temp, frac = self.layers
        return np.asarray(fn(prec, temp, self.etp, frac, *series, *INITS,
                             self.params, t_tile=64, interpret=True, **kw))

    def objective(self, hyst=False, ice=False, **kw):
        return fused_snow.snowgr4j_ensemble_mse_fused(
            self.t_prec, self.t_temp, self.t_etp, self.t_frac, self.t_qobs,
            *INITS, self.t_params,
            frac_ice=self.t_frac_ice if ice else None, hyst=hyst, ice=ice,
            **kw)

    def simulate(self, hyst=False, ice=False, **kw):
        return fused_snow.snowgr4j_simulate_fused(
            self.t_prec, self.t_temp, self.t_etp, self.t_frac, *INITS,
            self.t_params, frac_ice=self.t_frac_ice if ice else None,
            hyst=hyst, ice=ice, **kw)

    def xla(self, variant):
        """The XLA composition mapped over members: every series."""
        hyst, ice = VARIANTS[variant]
        prec, temp, frac = self.layers
        fn = {"plain": jax_comp.run_cemaneigegr4j,
              "hyst": jax_comp.run_cemaneigehystgr4j,
              "ice": jax_comp.run_cemaneigegr4jice,
              "hyst+ice": jax_comp.run_cemaneigehystgr4jice}[variant]
        args = (prec, temp, self.etp) + ((self.frac_ice,) if ice else ())
        inits = INITS[:2] + ((0.0,) if hyst else ()) + INITS[2:]
        return jax.vmap(lambda p: fn(*args, frac, *inits, p))(
            {k: jnp.asarray(v) for k, v in self.params.items()})


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,mode,gaps,L", [
    ("plain", "mse", False, 1),
    ("ice", "stats", True, 5),
    ("hyst+ice", "sca_stats", True, 5),
])
def test_objective_plain_matches_pallas_interpret(variant, mode, gaps, L):
    hyst, ice = VARIANTS[variant]
    case = _Case(L=L, seed=1, gaps=gaps)
    modes = dict(stats=mode == "stats", sca_stats=mode == "sca_stats",
                 masked=gaps)
    want = case.pallas(
        jax_snow.snowgr4j_ensemble_mse_pallas, case.qobs,
        frac_ice=case.frac_ice if ice else None,
        ndsi=case.ndsi if mode == "sca_stats" else None, hyst=hyst, ice=ice,
        **modes)
    reset_launches()
    got = case.objective(hyst, ice, ndsi=case.t_ndsi
                         if mode == "sca_stats" else None, **modes)
    assert not any(LAUNCHES.values())     # CPU tensors: the plain version
    assert got.shape == {"mse": (12,), "stats": (4, 12),
                         "sca_stats": (4 + 4 * L, 12)}[mode]
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("variant,L,x4_hi", [("hyst+ice", 5, 9.9),
                                             ("plain", 1, 2.9),
                                             ("hyst", 1, 9.9),
                                             ("ice", 5, 2.9),
                                             ("hyst+ice", 2, 2.9)])
def test_traj_plain_matches_pallas_interpret(variant, L, x4_hi):
    """K9's plain version against the Pallas trajectory kernel: the layer
    counts K9 keeps in registers (1, 5) and one it keeps in shared-memory
    columns (2), each snow variant, both UH register pairs."""
    hyst, ice = VARIANTS[variant]
    case = _Case(L=L, seed=2, x4_hi=x4_hi)
    uh = dict(num_uh1=3, num_uh2=7) if x4_hi < 3 else {}
    want = case.pallas(jax_snow.snowgr4j_simulate_pallas,
                       frac_ice=case.frac_ice if ice else None, hyst=hyst,
                       ice=ice, **uh)
    got = case.simulate(hyst, ice, **uh)
    assert got.shape == (12, 150)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_snow_only_plain_matches_pallas_interpret():
    case = _Case(seed=3, gaps=True)
    prec, temp, frac = case.layers
    snow_params = {k: case.params[k] for k in ('CTG', 'Kf')}
    t_params = {k: case.t_params[k] for k in ('CTG', 'Kf')}
    want = np.asarray(jax_snow.cemaneige_simulate_pallas(
        prec, temp, frac, 2.0, -1.0, snow_params, t_tile=64, interpret=True))
    got = fused_snow.cemaneige_simulate_fused(
        case.t_prec, case.t_temp, case.t_frac, 2.0, -1.0, t_params)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    want = np.asarray(jax_snow.cemaneige_ensemble_mse_pallas(
        prec, temp, frac, case.qobs, 2.0, -1.0, snow_params, t_tile=64,
        interpret=True, stats=True, masked=True))
    got = fused_snow.cemaneige_ensemble_mse_fused(
        case.t_prec, case.t_temp, case.t_frac, case.t_qobs, 2.0, -1.0,
        t_params, stats=True, masked=True)
    assert got.shape == (4, 12)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


# ---------------------------------------------------------------------------
# plain versions vs the XLA compositions and the port's scan ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_traj_plain_matches_xla_composition(variant, L):
    hyst, ice = VARIANTS[variant]
    case = _Case(L=L, seed=4)
    want = np.asarray(case.xla(variant)[0])
    got = case.simulate(hyst, ice)
    np.testing.assert_allclose(got.numpy(), want, **ENGINE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stats_plain_match_scan_engine_metrics(variant):
    """MSE / NSE / KGE from the fused statistics against the masked metrics
    of the scan engine's trajectories, gaps included."""
    hyst, ice = VARIANTS[variant]
    case = _Case(seed=5, gaps=True)
    fn = {"plain": compositions.run_cemaneigegr4j,
          "hyst": compositions.run_cemaneigehystgr4j,
          "ice": compositions.run_cemaneigegr4jice,
          "hyst+ice": compositions.run_cemaneigehystgr4jice}[variant]
    args = (case.t_prec, case.t_temp, case.t_etp) + (
        (case.t_frac_ice,) if ice else ())
    inits = INITS[:2] + ((0.0,) if hyst else ()) + INITS[2:]
    qsim = fn(*args, case.t_frac, *inits, case.t_params)[0].numpy()
    losses = losses_from_stats(
        case.objective(hyst, ice, stats=True, masked=True), case.t_qobs)
    for name, metric in (('mse', jax_metrics.mse), ('nse', jax_metrics.nse),
                         ('kge', jax_metrics.kge)):
        want = np.asarray(metric(case.qobs[None, :], qsim, axis=-1))
        np.testing.assert_allclose(losses[name].numpy(), want, rtol=1e-8,
                                   err_msg=name)
    mse_only = case.objective(hyst, ice, masked=True)
    np.testing.assert_allclose(mse_only.numpy(), losses['mse'].numpy(),
                               rtol=1e-14)


@pytest.mark.parametrize("loss_metric", ["mse", "kge"])
def test_q_sca_loss_matches_jax_and_trajectory_loss(loss_metric):
    """The Q+SCA loss from K8's SCA statistics: the same statistics through
    JAX's ``q_sca_loss_from_stats`` (rtol=1e-12: one formula on one
    input), and the reference weighting on the XLA trajectories
    (rtol=1e-8)."""
    case = _Case(seed=6, gaps=True)
    stats = case.objective(True, True, ndsi=case.t_ndsi, sca_stats=True,
                           masked=True)
    got = fused_snow.q_sca_loss_from_stats(stats, case.t_qobs, case.t_ndsi,
                                           loss_metric)
    want = jax_snow.q_sca_loss_from_stats(
        jnp.asarray(stats.numpy()), jnp.asarray(case.qobs),
        jnp.asarray(case.ndsi), loss_metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)

    outs = case.xla("hyst+ice")
    qsim, sca = np.asarray(outs[0]), np.asarray(outs[5])        # sca (N, T, L)
    loss = jax_metrics.calibration_loss(loss_metric)
    ref = np.array([
        0.75 * float(loss(case.qobs, qsim[i])) + 0.05 * sum(
            float(loss(case.ndsi[band], 100.0 * sca[i, :, band]))
            for band in range(5))
        for i in range(len(qsim))])
    finite = np.isfinite(ref)                # a constant SCA has no KGE
    assert finite.sum() >= 6
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=1e-8)
    loss_q, loss_sca = fused_snow.q_sca_components_from_stats(
        stats, case.t_qobs, case.t_ndsi, loss_metric)
    np.testing.assert_allclose(
        (0.75 * loss_q + 0.05 * loss_sca).numpy()[finite],
        got.numpy()[finite], rtol=1e-14)


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_packing_layout_and_guarded_reciprocal():
    case = _Case(N=4, seed=7)
    packed = fused_snow.pack_params(case.t_params, 0.4, 0.3)
    assert packed.shape == (fused_snow.NUM_ROWS, 4) == (11, 4)
    p = case.t_params
    for row, want in zip(packed, (p['x1'], p['x2'], p['x3'], p['x4'],
                                  0.4 * p['x1'], 0.3 * p['x3'], p['CTG'],
                                  p['Kf'], 1.0 / p['Thacc'], p['Rsp'],
                                  p['DDF'])):
        assert torch.equal(row, want)
    # A variant without Thacc / Rsp / DDF packs finite zero rows.
    plain = fused_snow.pack_params(
        {k: p[k] for k in ('CTG', 'Kf', 'x1', 'x2', 'x3', 'x4')}, 0.0, 0.0)
    assert torch.isfinite(plain).all() and (plain[8:] == 0).all()
    snow_only = fused_snow.pack_params({k: p[k] for k in ('CTG', 'Kf')}, 0.0,
                                       0.0, snow_only=True)
    assert torch.isfinite(snow_only).all()
    snow, rain, consts = fused_snow.layer_inputs(case.t_prec, case.t_frac,
                                                 hyst=False)
    np.testing.assert_allclose((snow + rain).numpy(), case.layers[0],
                               rtol=1e-15)
    np.testing.assert_allclose(
        consts.numpy(), 0.9 * 365.25 * (case.layers[0]
                                        * case.layers[2]).mean(axis=0),
        rtol=1e-13)


def test_gaps_without_a_valid_step_raise():
    case = _Case(N=3, seed=8)
    with pytest.raises(ValueError, match="no finite value"):
        fused_snow.snowgr4j_ensemble_mse_fused(
            case.t_prec, case.t_temp, case.t_etp, case.t_frac,
            torch.full_like(case.t_qobs, torch.nan), *INITS, case.t_params,
            masked=True)
    ndsi = case.t_ndsi.clone()
    ndsi[2] = torch.nan
    with pytest.raises(ValueError, match="NDSI band has no finite value"):
        case.objective(True, False, ndsi=ndsi, sca_stats=True, masked=True)


def test_kernel_module_input_checks():
    case = _Case(N=3, seed=9)
    with pytest.raises(ValueError, match="mse/stats objectives"):
        case.objective(True, False, ndsi=case.t_ndsi, sca_stats=True,
                       state=object())
    with pytest.raises(ValueError, match="hysteresis"):
        case.objective(False, False, ndsi=case.t_ndsi, sca_stats=True)
    with pytest.raises(ValueError, match="ndsi"):
        case.objective(True, False, sca_stats=True)
    with pytest.raises(ValueError, match=r"ndsi must be \(5, 150\)"):
        case.objective(True, False, ndsi=case.t_ndsi[:4], sca_stats=True)
    with pytest.raises(ValueError, match="snow_only"):
        case.simulate(True, False, snow_only=True)
    with pytest.raises(ValueError, match="frac_ice"):
        fused_snow.snowgr4j_simulate_fused(
            case.t_prec, case.t_temp, case.t_etp, case.t_frac, *INITS,
            case.t_params, ice=True)
    with pytest.raises(ValueError, match="UH register lengths"):
        case.simulate(num_uh1=4, num_uh2=9)
    with pytest.raises(ValueError, match="one device and dtype"):
        fused_snow.snowgr4j_simulate_fused(
            case.t_prec.float(), case.t_temp, case.t_etp, case.t_frac,
            *INITS, case.t_params)
    with pytest.raises(ValueError, match=r"\(T, L\)"):
        fused_snow.snowgr4j_simulate_fused(
            case.t_prec[:-1], case.t_temp[:-1], case.t_etp, case.t_frac[:-1],
            *INITS, case.t_params)
    with pytest.raises(ValueError, match="one fraction per layer"):
        fused_snow.snowgr4j_simulate_fused(
            case.t_prec, case.t_temp, case.t_etp, case.t_frac, *INITS,
            case.t_params, frac_ice=case.t_frac_ice[:3], ice=True)
