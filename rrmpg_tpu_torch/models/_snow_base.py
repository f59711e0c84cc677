"""Shared validation, met preprocessing and engines of the Cemaneige model
family.

Counterpart of ``rrmpg_tpu/models/_snow_base.py`` (validation and
elevation-layer preprocessing once for all five snow classes, error types
and messages as in the reference,
``rrmpg/models/cemaneige.py:132-200``).  :class:`CemaneigeBase` holds what
every snow class needs; :class:`SnowGR4JBase` adds what the four GR4J
compositions share -- they differ only in two flags (hysteresis, ice melt)
and in their parameter lists, so ``simulate`` / ``fit`` / ``fit_Q_SCA`` are
written once here and each class keeps the reference's signature.

Engines: ``'scan'`` is plain batched PyTorch (:mod:`..ops.compositions`),
``'fused'`` the hand-written CUDA kernels K8 / K9 (:mod:`..ops.fused_snow`)
for CUDA tensors, on the CPU their plain versions.

Forecast mode of the compositions: ``return_final_state=True`` also
returns the end-of-series :class:`~.states.SnowGR4JState`, and
``initial_state=`` continues from one, on both engines (``'fused'``: the
state kernel K10, discharge only); ``fit(initial_state=)`` calibrates a
continuation segment from one shared state on both engines (``'fused'``:
the warm entry of K8), ``fit_Q_SCA(initial_state=)`` on ``'scan'`` only.
``fit_Q_SCA(pareto=True)`` (cold starts) returns the Q-vs-SCA Pareto front
of NSGA-II (:mod:`..tools.moo`), on ``'fused'`` one K8 launch a generation.
The state carries the layer constants of the series that produced it (the
snow-cover threshold, or the mean annual solid precipitation): a
continuation uses those, never its own forcing's.
"""

import numbers
import typing

import numpy as np
import torch

from ..ops.cemaneige import run_cemaneigehyst_warm
from ..ops._launch import valid_count
from ..ops.compositions import (
    _weighted_icemelt,
    run_cemaneigegr4j,
    run_cemaneigegr4j_warm,
    run_cemaneigegr4jice,
    run_cemaneigehystgr4j,
    run_cemaneigehystgr4j_warm,
    run_cemaneigehystgr4jice,
)
from ..ops.fused_snow import (
    q_sca_components_from_stats,
    q_sca_loss_from_stats,
    snowgr4j_ensemble_mse_fused,
    snowgr4j_simulate_fused,
    snowgr4j_simulate_state_fused,
)
from ..ops.gr4j import run_gr4j_warm
from ..ops.met import (
    calculate_solid_fraction,
    extrapolate_precipitation,
    extrapolate_temperature,
)
from ..ops.stats import losses_from_stats
from ..ops.uh import NUM_UH1, NUM_UH2, required_uh_lengths
from ..parallel.mesh import check_mesh
from ..utils.array_checks import check_for_negatives, validate_array_input
from ..utils.metrics import calibration_loss
from .basemodel import (BaseModel, check_engine, check_fused_mesh,
                        check_stats_mesh)
from .gr4j import GR4J, fit_uh_lengths
from .states import (
    CemaneigeHystState,
    CemaneigeState,
    SnowGR4JState,
    broadcast_state,
    check_state_type,
)

NUM_NDSI_BANDS = 5


def _check_return_storage(value, name='return_storage'):
    if not isinstance(value, bool):
        raise TypeError(
            f"'{name}' expects a bool, got {type(value).__name__}.")


def stats_objective(evaluate, qobs, loss_metric):
    """Turn ``evaluate(params, stats) -> (N,) MSE or (4, N) statistics``
    into a loss: 'mse'/'rmse' from the squared error, 'nse'/'kge' as
    ``1 - score`` from the sufficient statistics."""
    calibration_loss(loss_metric)          # raises on an unknown metric
    use_stats = loss_metric in ("nse", "kge")

    def loss(params):
        out = evaluate(params, use_stats)
        if use_stats:
            return 1.0 - losses_from_stats(out, qobs)[loss_metric]
        if loss_metric == "rmse":
            return torch.sqrt(out)
        return out

    return loss


class CemaneigeBase(BaseModel):
    """Base class for models containing the Cemaneige snow routine."""

    @staticmethod
    def _validate_met(prec, mean_temp, min_temp, max_temp,
                      met_station_height, altitudes, extra_series=()):
        """Validate inputs and extrapolate them to elevation layers.

        Args:
            prec, mean_temp, min_temp, max_temp: (T,) station series.
            met_station_height: station elevation [m].
            altitudes: list of median layer elevations (may be empty for a
                single layer at station height).
            extra_series: additional (name, array) pairs that must have the
                same length as prec (e.g. etp, NDSI bands); returned
                validated in order.

        Returns:
            (prec, mean_temp, frac_solid_prec, altitudes, extras) as float64
            numpy arrays, with layer arrays of shape (T, L).
        """
        prec = validate_array_input(prec, np.float64, 'prec')
        mean_temp = validate_array_input(mean_temp, np.float64, 'mean_temp')
        min_temp = validate_array_input(min_temp, np.float64, 'min_temp')
        max_temp = validate_array_input(max_temp, np.float64, 'max_temp')
        extras = [validate_array_input(arr, np.float64, name)
                  for name, arr in extra_series]

        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        if any(len(ar) != len(prec)
               for ar in [mean_temp, min_temp, max_temp] + extras):
            raise RuntimeError(
                "Every meteorological series passed to this model needs the "
                f"same length as prec ({len(prec)}).")

        if not isinstance(altitudes, list):
            raise TypeError(
                f"'altitudes' expects a list of elevation-band heights, got "
                f"{type(altitudes).__name__}.")
        if len(altitudes) > 0:
            bad = [v for v in altitudes if not isinstance(v, numbers.Number)]
            if bad:
                raise TypeError(
                    f"'altitudes' contains non-numeric entries: {bad}.")
            if met_station_height is None:
                raise ValueError(
                    "Elevation-band extrapolation needs "
                    "'met_station_height', which was not given.")
            if not isinstance(met_station_height, numbers.Number):
                raise TypeError(
                    "'met_station_height' needs a numeric scalar, got "
                    f"{type(met_station_height).__name__}.")
            altitudes = np.array(altitudes)

        if not isinstance(met_station_height, numbers.Number):
            raise TypeError(
                "'met_station_height' needs a numeric scalar, got "
                f"{type(met_station_height).__name__}.")

        # The preprocessing is a few elementwise passes over (T, L): it runs
        # on the host in float64, whatever the model's device and dtype.
        prec, mean_temp, min_temp, max_temp = (
            torch.from_numpy(np.ascontiguousarray(a))
            for a in (prec, mean_temp, min_temp, max_temp))
        if len(altitudes) > 0:
            prec = extrapolate_precipitation(prec, altitudes,
                                             met_station_height)
            min_temp, mean_temp, max_temp = extrapolate_temperature(
                min_temp, mean_temp, max_temp, altitudes, met_station_height)
        else:
            prec, mean_temp, min_temp, max_temp = (
                a[:, None] for a in (prec, mean_temp, min_temp, max_temp))
            altitudes = np.array([met_station_height])

        frac_solid_prec = calculate_solid_fraction(
            prec, altitudes, mean_temp, min_temp, max_temp)

        return (prec.numpy(), mean_temp.numpy(), frac_solid_prec.numpy(),
                altitudes, extras)

    @staticmethod
    def _validate_number(value, name):
        if not isinstance(value, numbers.Number):
            raise TypeError(
                f"'{name}' needs a numeric scalar, got {type(value).__name__}.")
        return float(value)

    @staticmethod
    def _validate_frac_ice(frac_ice):
        """Validate the glacier-fraction array of the ice-melt variants.

        Reference semantics (``rrmpg/models/cemaneigegr4jice.py:200-208``):
        must be 1-D; coerced to a numpy array.
        """
        if isinstance(frac_ice, np.ndarray) and frac_ice.ndim != 1:
            raise ValueError(
                f"'frac_ice' needs one glaciated fraction per elevation "
                f"band (a flat array); got ndim={frac_ice.ndim}.")
        return np.asarray(frac_ice, dtype=np.float64)

    @staticmethod
    def _check_no_cold_inits(initial_state, inits, names):
        if initial_state is not None and any(v != 0 for v in inits):
            raise ValueError(
                "Pass either the cold-start init scalars "
                f"({', '.join(names)}) or a full initial_state (warm "
                "continuation), not both.")

    @staticmethod
    def _check_layers(state_layers, num_layers):
        if state_layers != num_layers:
            raise ValueError(
                f"initial_state carries {state_layers} "
                f"elevation layer(s) but the forcing resolves to "
                f"{num_layers}; altitudes/met setup must match the run "
                "that produced the state.")

    def _candidates(self, X):
        """(P, dim) candidate matrix -> dict of contiguous (P,) columns."""
        return {name: X[:, j].contiguous()
                for j, name in enumerate(self._param_list)}

    def _minimize(self, objective, seed, de_kwargs):
        from ..tools.calibration import minimize

        bounds = tuple(self._default_bounds[p] for p in self._param_list)
        return minimize(objective, bounds, seed=seed, batched=True,
                        device=self.device, dtype=self.dtype, **de_kwargs)


class _Forcing(typing.NamedTuple):
    """Validated inputs of one call, as tensors on the model's device."""
    prec: torch.Tensor                 # (T, L)
    mean_temp: torch.Tensor            # (T, L)
    etp: torch.Tensor                  # (T,)
    frac_solid_prec: torch.Tensor      # (T, L)
    frac_ice: typing.Optional[torch.Tensor]   # (L,), ice variants
    snow_pack_init: float
    thermal_state_init: float
    sca_init: float
    s_init: float
    r_init: float
    extras: tuple                      # further (T,) series (NDSI bands)


class SnowGR4JBase(CemaneigeBase):
    """What the four Cemaneige + GR4J compositions share.  Subclasses set
    ``_hyst`` / ``_ice`` and keep the reference's method signatures."""

    _hyst = False
    _ice = False

    def _prepare(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, altitudes, snow_pack_init,
                 thermal_state_init, sca_init, s_init, r_init,
                 extra_series=()):
        extra = (('pot. evapotranspiration', etp),) + tuple(extra_series)
        prec, mean_temp, frac_solid_prec, _, extras = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, extra_series=extra)
        if self._ice:
            frac_ice = self._tensor(self._validate_frac_ice(frac_ice))
        snow_pack_init = self._validate_number(snow_pack_init,
                                               'snow_pack_init')
        thermal_state_init = self._validate_number(thermal_state_init,
                                                   'thermal_state_init')
        sca_init = self._validate_number(sca_init, 'sca_init')
        s_init, r_init = GR4J._validate_inits(s_init, r_init)
        return _Forcing(
            self._tensor(prec), self._tensor(mean_temp),
            self._tensor(extras[0]), self._tensor(frac_solid_prec),
            frac_ice if self._ice else None, snow_pack_init,
            thermal_state_init, sca_init, s_init, r_init,
            tuple(self._tensor(x) for x in extras[1:]))

    # ------------------------------------------------------------------
    # The two engines
    # ------------------------------------------------------------------

    def _run_scan(self, f, params, num_uh1, num_uh2, return_final=False):
        """The composition on the ``'scan'`` engine (cold start); returns
        the op's series in the reference's order, member axis first, with
        ``return_final`` followed by the op's ``(snow_final, gr4j_final)``
        pair."""
        snow_inits = (f.snow_pack_init, f.thermal_state_init)
        if self._hyst:
            snow_inits += (f.sca_init,)
        tail = (*snow_inits, f.s_init, f.r_init, params, num_uh1, num_uh2,
                return_final)
        if self._ice:
            run = (run_cemaneigehystgr4jice if self._hyst
                   else run_cemaneigegr4jice)
            return run(f.prec, f.mean_temp, f.etp, f.frac_ice,
                       f.frac_solid_prec, *tail)
        run = run_cemaneigehystgr4j if self._hyst else run_cemaneigegr4j
        return run(f.prec, f.mean_temp, f.etp, f.frac_solid_prec, *tail)

    def _scan_members(self, run, f, params, mesh, state=None):
        """``run(f, [state,] params) -> (series, final)`` (``final`` None
        for a cold start without state) over the members, at once or split
        over ``mesh`` (:meth:`BaseModel._ensemble`); returns (series,
        final).  The hysteresis rain series (last, (T, L), the same for
        every member) stays out of the split: each call drops it and the
        first one's is kept."""
        rain = []

        def batched(f, *rest):
            series, final = run(f, *rest)
            if self._hyst:
                rain.append(series[-1])
                series = series[:-1]
            return (*series, final)

        *series, final = self._ensemble(batched, (f,), params, mesh, state)
        if self._hyst:
            series.append(rain[0].to(series[0].device))
        return tuple(series), final

    def _series_layout(self, outputs):
        """The op's series (member axis first) in the reference layout,
        member axis last: (T, N) and (T, L, N).  The rain series (last of
        the hysteresis outputs) is (T, L), the same for every member."""
        series = list(self._to_reference_layout(outputs))
        if self._hyst and len(outputs) > 1:
            rain = outputs[-1]
            series[-1] = rain[:, :, None].expand(*rain.shape,
                                                 outputs[0].shape[0])
        return tuple(series)

    # ------------------------------------------------------------------
    # Forecast mode
    # ------------------------------------------------------------------

    @property
    def _snow_state_cls(self):
        return CemaneigeHystState if self._hyst else CemaneigeState

    def _cold_inits(self, f):
        """(values, names) of the cold-start scalars of this class."""
        names = ('snow_pack_init', 'thermal_state_init')
        if self._hyst:
            names += ('sca_init',)
        names += ('s_init', 'r_init')
        return tuple(getattr(f, k) for k in names), names

    def _warm_state(self, initial_state, num_layers, num=None):
        """A checked ``initial_state``: batched over ``num`` members, or
        (``num=None``) the single shared state of a calibration."""
        check_state_type(initial_state, SnowGR4JState, type(self).__name__,
                         snow_cls=self._snow_state_cls)
        state = (self._single_member_state(initial_state) if num is None
                 else self._normalize_state(initial_state, num))
        self._check_layers(state.snow.g.shape[-1], num_layers)
        return state

    def _run_scan_final(self, f, params, num_uh1, num_uh2):
        """Cold start on the ``'scan'`` engine; returns (series, final
        :class:`~.states.SnowGR4JState`)."""
        *series, (snow_final, gr4j_final) = self._run_scan(
            f, params, num_uh1, num_uh2, return_final=True)
        *carry, consts = snow_final
        snow = self._snow_state_cls(*carry, consts.expand_as(carry[0]))
        return tuple(series), SnowGR4JState(snow=snow, gr4j=gr4j_final)

    def _run_scan_warm(self, f, params, state, num_uh1, num_uh2):
        """Continue from a batched ``state`` on the ``'scan'`` engine;
        returns (series in the class's reference order, final state)."""
        sg = state.snow
        forcing = (f.prec, f.mean_temp, f.etp, f.frac_solid_prec)
        if not self._hyst:
            (qsim, G, eTG, s_store, r_store, icemelt,
             (snow_carry, gr4j_final)) = run_cemaneigegr4j_warm(
                *forcing, ((sg.g, sg.etg), state.gr4j), sg.g_thresh, params,
                num_uh1, num_uh2, frac_ice=f.frac_ice)
            series = (qsim, G, eTG, s_store, r_store)
            if self._ice:
                series += (icemelt,)
        elif not self._ice:
            (qsim, G, eTG, s_store, r_store, sca, rain, _,
             (snow_carry, gr4j_final)) = run_cemaneigehystgr4j_warm(
                *forcing, ((sg.g, sg.etg, sg.sca, sg.swe_max), state.gr4j),
                sg.psol_annual, params, num_uh1, num_uh2)
            series = (qsim, G, eTG, s_store, r_store, sca, rain)
        else:
            # From the stage functions, not the composition's warm op: this
            # class also returns the snow routine's outflow series
            # (``cemaneigehystgr4jice_model.py:88-104``).
            snowmelt, G, eTG, sca, rain, snow_carry = run_cemaneigehyst_warm(
                f.prec, f.mean_temp, f.frac_solid_prec,
                (sg.g, sg.etg, sg.sca, sg.swe_max), sg.psol_annual, params)
            icemelt = _weighted_icemelt(f.mean_temp, G, f.frac_ice, params)
            qsim, s_store, r_store, gr4j_final = run_gr4j_warm(
                (snowmelt + icemelt).T, f.etp, state.gr4j, params, num_uh1,
                num_uh2)
            series = (qsim, G, eTG, s_store, r_store, sca, icemelt, snowmelt,
                      rain)
        # The warm ops return only the evolving carry; the series-derived
        # constant (g_thresh / psol_annual) passes through.
        snow = self._snow_state_cls(*snow_carry, sg[-1])
        return series, SnowGR4JState(snow=snow, gr4j=gr4j_final)

    def _simulate_stateful(self, f, param_dict, initial_state,
                           return_final_state, return_storage, engine,
                           mesh=None):
        """Forecast-mode execution shared by the four compositions (on a
        mesh, ``'scan'`` only, the state split with the members)."""
        num = param_dict['CTG'].shape[0]
        n1, n2 = required_uh_lengths(param_dict['x4'])
        state = None
        if initial_state is not None:
            state = self._warm_state(initial_state, f.prec.shape[1], num)
            GR4J._check_history_depth(state.gr4j.pr_history.shape[-1], n2,
                                      param_dict['x4'])
        if engine == "fused":
            # sca_init is inert (a quirk of the reference's hysteresis
            # routine that every engine keeps).
            qsim, final = snowgr4j_simulate_state_fused(
                f.prec, f.mean_temp, f.etp, f.frac_solid_prec, param_dict,
                state=state, snow_pack_init=f.snow_pack_init,
                thermal_state_init=f.thermal_state_init, s_init=f.s_init,
                r_init=f.r_init, frac_ice=f.frac_ice, hyst=self._hyst,
                ice=self._ice, num_uh1=n1, num_uh2=n2)
            series = (qsim,)
        elif state is None:
            series, final = self._scan_members(
                lambda f, params: self._run_scan_final(f, params, n1, n2),
                f, param_dict, mesh)
        else:
            series, final = self._scan_members(
                lambda f, state, params: self._run_scan_warm(
                    f, params, state, n1, n2),
                f, param_dict, mesh, state)
        return self._stateful_output(self._series_layout(series), final,
                                     return_storage, return_final_state)

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """``(time_arrays, warm_step)`` for the device-resident assimilation
        cycle (see ``GR4J._warm_cycle_pieces``), shared by the four
        compositions: the met preprocessing (elevation-layer extrapolation
        and solid fraction) runs once over the full series on the host, in
        float64; the step advances one window from a carried
        :class:`~.states.SnowGR4JState`, on ``sim_kwargs``' ``engine``
        ('scan' by default, or 'fused' for the warm entry of K10).  The UH
        lengths come from the class bound of x4."""
        kw = dict(sim_kwargs)
        met_station_height = kw.pop('met_station_height', None)
        altitudes = kw.pop('altitudes', [])
        frac_ice = kw.pop('frac_ice', None)
        engine = kw.pop('engine', 'scan')
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for {type(self).__name__} "
                f"cycling: {sorted(kw)}.")
        if self._ice and frac_ice is None:
            raise ValueError(
                f"{type(self).__name__} cycling needs 'frac_ice'.")
        check_engine(engine)
        prec, mean_temp, frac_solid, _, (etp,) = self._validate_met(
            forcings['prec'], forcings['mean_temp'], forcings['min_temp'],
            forcings['max_temp'], met_station_height, altitudes,
            extra_series=(('etp', forcings['etp']),))
        fi = (self._tensor(self._validate_frac_ice(frac_ice)) if self._ice
              else None)
        x4_hi = self._default_bounds['x4'][1]
        n1, n2 = required_uh_lengths(x4_hi)

        def warm_step(arrays, state, params):
            prec_w, mt_w, etp_w, fs_w = arrays
            self._check_layers(state.snow.g.shape[-1], prec_w.shape[1])
            GR4J._check_history_depth(state.gr4j.pr_history.shape[-1], n2,
                                      [x4_hi])
            if engine == "fused":
                return snowgr4j_simulate_state_fused(
                    prec_w, mt_w, etp_w, fs_w, params, state=state,
                    frac_ice=fi, hyst=self._hyst, ice=self._ice,
                    num_uh1=n1, num_uh2=n2)
            f = _Forcing(prec_w, mt_w, etp_w, fs_w, fi, 0.0, 0.0, 0.0, 0.0,
                         0.0, ())
            series, final = self._run_scan_warm(f, params, state, n1, n2)
            return series[0], final

        return (tuple(self._tensor(a) for a in (prec, mean_temp, etp,
                                                 frac_solid)), warm_step)

    def _fused_simulate(self, f, params):
        """Discharge-only fused simulation (K9); (N, T)."""
        n1, n2 = required_uh_lengths(params['x4'])
        return snowgr4j_simulate_fused(
            f.prec, f.mean_temp, f.etp, f.frac_solid_prec, f.snow_pack_init,
            f.thermal_state_init, f.s_init, f.r_init, params,
            frac_ice=f.frac_ice, hyst=self._hyst, ice=self._ice, num_uh1=n1,
            num_uh2=n2)

    def _fused_objective_stats(self, f, qobs, params, **modes):
        """One launch of K8 at the UH lengths the class bounds need."""
        n1, n2 = fit_uh_lengths(self._default_bounds['x4'][1])
        return snowgr4j_ensemble_mse_fused(
            f.prec, f.mean_temp, f.etp, f.frac_solid_prec, qobs,
            f.snow_pack_init, f.thermal_state_init, f.s_init, f.r_init,
            params, frac_ice=f.frac_ice, hyst=self._hyst, ice=self._ice,
            num_uh1=n1, num_uh2=n2, **modes)

    def _fused_batch_objective(self, loss_metric, f, qobs):
        """Batched DE objective backed by K8: a (P, dim) candidate matrix
        (columns ordered as ``_param_list``) -> (P,) losses in one launch.
        'mse'/'rmse' accumulate squared error; 'nse'/'kge' run the
        statistics mode and minimize ``1 - score``."""
        masked = bool(torch.isnan(qobs).any())
        count = valid_count(qobs, masked)
        loss = stats_objective(
            lambda params, stats: self._fused_objective_stats(
                f, qobs, params, stats=stats, masked=masked, count=count),
            qobs, loss_metric)
        return lambda X: loss(self._candidates(X))

    def _fused_q_sca_objective(self, loss_metric, f, qobs, ndsi,
                               components=False):
        """Batched Q+SCA objective backed by K8's ``sca_stats`` mode: the
        discharge and per-band 100*SCA statistics come from one launch;
        the reference's 0.75 / 5 x 0.05 weighting is applied to them.  With
        ``components=True`` the objective returns the (P, 2) pair
        ``(L_q, L_sca)`` instead, for the Pareto fit."""
        if loss_metric not in ("mse", "kge"):
            raise ValueError(
                f"Unsupported loss_metric {loss_metric!r} for the fused "
                "Q+SCA statistics path; supported: 'mse', 'kge'.")
        masked = bool(torch.isnan(qobs).any() or torch.isnan(ndsi).any())

        def objective(X):
            stats = self._fused_objective_stats(
                f, qobs, self._candidates(X), ndsi=ndsi, sca_stats=True,
                masked=masked)
            if components:
                return torch.stack(q_sca_components_from_stats(
                    stats, qobs, ndsi, loss_metric), dim=1)
            return q_sca_loss_from_stats(stats, qobs, ndsi, loss_metric)

        return objective

    # ------------------------------------------------------------------
    # simulate / fit / fit_Q_SCA, shared by the four classes
    # ------------------------------------------------------------------

    def _simulate(self, f, return_storage, params, mesh, engine,
                  initial_state, return_final_state):
        _check_return_storage(return_storage)
        check_engine(engine)
        check_mesh(mesh)
        self._check_no_cold_inits(initial_state, *self._cold_inits(f))
        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, return_storage, mesh)
            return self._simulate_stateful(
                f, param_dict, initial_state, return_final_state,
                return_storage, engine, mesh)
        if engine == "fused":
            check_fused_mesh(mesh)
            if return_storage:
                raise ValueError(
                    "engine='fused' computes discharge only; use "
                    "engine='scan' for storage trajectories.")
            return self._fused_simulate(f, param_dict).T
        n1, n2 = required_uh_lengths(param_dict['x4'])
        outputs, _ = self._scan_members(
            lambda f, params: (self._run_scan(f, params, n1, n2), None),
            f, param_dict, mesh)
        if not return_storage:
            return outputs[0].T
        return self._series_layout(outputs)

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """(4, N) time-mean sufficient statistics from K8: the
        trajectory-free evaluation behind
        ``monte_carlo(return_qsim=False, engine='fused')``."""
        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        check_stats_mesh(kw)
        forcing = [kw.pop(k) for k in ("prec", "mean_temp", "min_temp",
                                       "max_temp", "etp")]
        frac_ice = kw.pop("frac_ice", None) if self._ice else None
        if self._ice and frac_ice is None:
            raise ValueError(f"{type(self).__name__} needs 'frac_ice'.")
        met_station_height = kw.pop("met_station_height")
        altitudes = kw.pop("altitudes", [])
        inits = [kw.pop(k, 0) for k in ("snow_pack_init",
                                        "thermal_state_init")]
        # sca_init is inert (reference parity) but part of the signature.
        sca_init = kw.pop("sca_init", 0) if self._hyst else 0
        gr4j_inits = [kw.pop(k, 0) for k in ("s_init", "r_init")]
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        f = self._prepare(*forcing, frac_ice, met_station_height, altitudes,
                          *inits, sca_init, *gr4j_inits)
        qobs = np.asarray(qobs, np.float64)
        return self._fused_objective_stats(
            f, self._tensor(qobs), param_dict, stats=True,
            masked=bool(np.isnan(qobs).any()))

    def _warm_objective(self, loss_metric, f, qobs, state, engine,
                        ndsi=None):
        """Batched DE objective of a continuation segment: every candidate
        starts from the one shared single-member ``state`` (checked by
        :meth:`_warm_state`), broadcast to the candidate batch.  'fused'
        evaluates a generation with one launch of K8's warm entry
        (discharge objectives); 'scan' runs the warm composition and, with
        ``ndsi``, adds the reference's 0.75 / 5 x 0.05 discharge + SCA
        weighting."""
        loss = calibration_loss(loss_metric)
        if engine == "fused":
            x4_hi = self._default_bounds['x4'][1]
            GR4J._check_history_depth(state.gr4j.pr_history.shape[-1],
                                      fit_uh_lengths(x4_hi)[1], [x4_hi])
            masked = bool(torch.isnan(qobs).any())
            count = valid_count(qobs, masked)
            fused_loss = stats_objective(
                lambda params, stats: self._fused_objective_stats(
                    f, qobs, params, stats=stats, masked=masked,
                    state=broadcast_state(state, params['CTG'].shape[0]),
                    count=count),
                qobs, loss_metric)
            return lambda X: fused_loss(self._candidates(X))

        def objective(X):
            series, _ = self._run_scan_warm(
                f, self._candidates(X), broadcast_state(state, X.shape[0]),
                NUM_UH1, NUM_UH2)
            loss_q = loss(qobs[None, :], series[0], dim=-1)
            if ndsi is None:
                return loss_q
            sca = 100.0 * series[5]                        # (N, T, L)
            loss_sca = sum(loss(ndsi[b][None, :], sca[:, :, b], dim=-1)
                           for b in range(NUM_NDSI_BANDS))
            return 0.75 * loss_q + 0.05 * loss_sca

        return objective

    def _fit(self, obs, f, loss_metric, seed, engine, initial_state,
             de_kwargs):
        check_engine(engine)
        loss = calibration_loss(loss_metric)
        qobs = self._tensor(validate_array_input(obs, np.float64, 'obs'))
        self._check_no_cold_inits(initial_state, *self._cold_inits(f))
        state = (None if initial_state is None
                 else self._warm_state(initial_state, f.prec.shape[1]))

        def build(f, qobs, state):
            """The objective over tensors on one device."""
            if state is not None:
                return self._warm_objective(loss_metric, f, qobs, state,
                                            engine)
            if engine == "fused":
                return self._fused_batch_objective(loss_metric, f, qobs)

            def objective(X):
                qsim = self._run_scan(f, self._candidates(X), NUM_UH1,
                                      NUM_UH2)[0]
                return loss(qobs[None, :], qsim, dim=-1)
            return objective

        objective = self._objective_per_device(build, (f, qobs, state),
                                               de_kwargs.get("mesh"))
        return self._minimize(objective, seed, de_kwargs)

    def _fit_q_sca(self, obs, f, loss_metric, seed, engine, initial_state,
                   pareto, de_kwargs):
        check_engine(engine)
        if pareto and initial_state is not None:
            raise ValueError(
                "fit_Q_SCA(pareto=True) supports cold starts only; run "
                "the scalarized fit for the warm path.")
        loss = calibration_loss(loss_metric)
        qobs = self._tensor(validate_array_input(obs, np.float64, 'obs'))
        if f.prec.shape[1] != NUM_NDSI_BANDS:
            raise ValueError(
                f"fit_Q_SCA compares {NUM_NDSI_BANDS} NDSI series with the "
                f"snow-covered area of {NUM_NDSI_BANDS} elevation bands; "
                f"'altitudes' gives {f.prec.shape[1]}.")
        ndsi = torch.stack(f.extras)                       # (5, T)
        self._check_no_cold_inits(initial_state, *self._cold_inits(f))
        state = None
        if initial_state is not None:
            if engine == "fused":
                raise ValueError(
                    "fit_Q_SCA(initial_state=) supports engine='scan' "
                    "only; the fused warm kernel covers the discharge "
                    "objectives.")
            state = self._warm_state(initial_state, f.prec.shape[1])

        def build(f, qobs, ndsi, state):
            """The objective over tensors on one device."""
            if state is not None:
                return self._warm_objective(loss_metric, f, qobs, state,
                                            engine, ndsi)
            if engine == "fused":
                return self._fused_q_sca_objective(loss_metric, f, qobs,
                                                   ndsi, components=pareto)
            sca_index = 5                                  # in both orders

            def objective(X):
                outputs = self._run_scan(f, self._candidates(X), NUM_UH1,
                                         NUM_UH2)
                loss_q = loss(qobs[None, :], outputs[0], dim=-1)
                sca = 100.0 * outputs[sca_index]           # (N, T, L)
                loss_sca = sum(loss(ndsi[b][None, :], sca[:, :, b], dim=-1)
                               for b in range(NUM_NDSI_BANDS))
                if pareto:
                    return torch.stack([loss_q, loss_sca], dim=1)
                return 0.75 * loss_q + 0.05 * loss_sca
            return objective

        objective = self._objective_per_device(
            build, (f, qobs, ndsi, state), de_kwargs.get("mesh"))
        if pareto:
            from ..tools.moo import nsga2

            bounds = tuple(self._default_bounds[p] for p in self._param_list)
            return nsga2(objective, bounds, seed=seed, batched=True,
                         device=self.device, dtype=self.dtype, **de_kwargs)
        return self._minimize(objective, seed, de_kwargs)
