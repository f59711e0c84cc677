"""Cemaneige-Hysteresis + GR4J coupled model interface class.

Counterpart of ``rrmpg_tpu.models.cemaneigehystgr4j.CemaneigeHystGR4J``:
eight parameters (CTG, Kf, Thacc, Rsp, x1..x4 with widened GR4J bounds),
``fit`` and the multi-objective ``fit_Q_SCA`` calibration against discharge
plus five NDSI snow-cover bands (weights 0.75 / 5 x 0.05,
``rrmpg/models/cemaneigehystgr4j.py:663-689``), with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'`` (see
:mod:`._snow_base`).

As in ``rrmpg_tpu`` (and unlike the reference's single-objective KGE loss,
which minimizes the efficiency itself), every 'kge' path minimizes
``1 - kge``.
"""

import numpy as np

from ..config import DEFAULT_DEVICE
from ._snow_base import SnowGR4JBase


def _ndsi_series(bands):
    return tuple((f'NDSI{i + 1}', arr) for i, arr in enumerate(bands))


class CemaneigeHystGR4J(SnowGR4JBase):
    """Interface to the Cemaneige-Hysteresis + GR4J coupled model."""

    _hyst = True

    _param_list = ['CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10),
                       'Thacc': (0, 1000),
                       'Rsp': (0, 1),
                       'x1': (10, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 5000),
                       'x4': (1.1, 10)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('Thacc', np.float64),
                       ('Rsp', np.float64),
                       ('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=None):
        super().__init__(params=params, device=device, dtype=dtype)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 sca_init=0, s_init=0, r_init=0, altitudes=[],
                 return_storage=False, params=None, mesh=None,
                 engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate the coupled hysteresis snow + runoff model.

        Args as :meth:`CemaneigeGR4J.simulate`, plus ``sca_init`` (initial
        snow-covered area fraction; without effect, as in the reference).

        Returns:
            qsim (T, N); plus G, eTG, sca, rain (each (T, L, N)) and
            s_store, r_store (each (T, N)) if ``return_storage``, ordered
            (qsim, G, eTG, s_store, r_store, sca, rain) as in the reference
            (``cemaneigehystgr4j.py:287-290``).
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, None,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init)
        return self._simulate(f, return_storage, params, mesh, engine,
                              initial_state, return_final_state)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp,
            met_station_height, loss_metric="mse", snow_pack_init=0,
            thermal_state_init=0, sca_init=0, s_init=0, r_init=0,
            altitudes=[], seed=None, engine="scan", initial_state=None,
            **de_kwargs):
        """Calibrate on observed discharge with differential evolution on
        the model's device.

        Args:
            obs: observed discharge; NaN marks a gap.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            engine: 'scan', or 'fused' to evaluate every DE generation with
                one launch of the fused objective kernel K8.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, None,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init)
        return self._fit(obs, f, loss_metric, seed, engine, initial_state,
                         de_kwargs)

    def fit_Q_SCA(self, obs, prec, mean_temp, min_temp, max_temp, etp,
                  NDSI1, NDSI2, NDSI3, NDSI4, NDSI5, met_station_height,
                  loss_metric="mse", snow_pack_init=0, thermal_state_init=0,
                  sca_init=0, s_init=0, r_init=0, altitudes=[], seed=None,
                  engine="scan", initial_state=None, pareto=False,
                  **de_kwargs):
        """Multi-objective calibration on discharge + snow-covered area.

        The loss is ``0.75 * L(obs, qsim) + 0.05 * sum_b L(NDSI_b,
        100 * sca_b)`` over the five elevation bands, following the
        reference (``cemaneigehystgr4j.py:663-689``).  NaN in the discharge
        or in a band is a gap of that series alone.

        Args:
            NDSI1..NDSI5: (T,) observed snow cover [0, 100] per band.
            loss_metric: any of 'mse', 'rmse', 'nse', 'kge' on
                ``engine='scan'``; 'mse' or 'kge' on ``engine='fused'``,
                which takes every term from one launch of K8's SCA
                statistics.
            pareto: replace the fixed 75 / 5 blend by a bi-objective
                optimization of ``(L_q, L_sca)`` with
                :func:`rrmpg_tpu_torch.tools.moo.nsga2` and return the whole
                Q-vs-SCA Pareto front (``**de_kwargs`` then holds nsga2's
                arguments, e.g. ``pop_size`` / ``n_generations``; on
                ``engine='fused'`` one K8 launch a generation).  Cold
                starts only: with ``initial_state`` it raises
                ``ValueError``.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`,
            or a :class:`~rrmpg_tpu_torch.tools.moo.ParetoResult` with
            ``pareto=True``.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, None,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init,
                          extra_series=_ndsi_series(
                              (NDSI1, NDSI2, NDSI3, NDSI4, NDSI5)))
        return self._fit_q_sca(obs, f, loss_metric, seed, engine,
                               initial_state, pareto, de_kwargs)
