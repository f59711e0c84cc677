"""Cemaneige-Hysteresis + degree-day ice melt + GR4J interface class.

Counterpart of
``rrmpg_tpu.models.cemaneigehystgr4jice.CemaneigeHystGR4JIce``: nine
parameters (CTG, Kf, Thacc, Rsp, x1..x4, DDF) and the ``frac_ice`` glacier
fractions, ``fit`` (``'kge'`` minimizes ``1 - kge``) and the
multi-objective ``fit_Q_SCA``, with ``engine='scan'|'fused'`` in place of
``'xla'|'pallas'`` (see :mod:`._snow_base`).
"""

import numpy as np

from ..config import DEFAULT_DEVICE
from ._snow_base import SnowGR4JBase
from .cemaneigehystgr4j import _ndsi_series


class CemaneigeHystGR4JIce(SnowGR4JBase):
    """Interface to the Cemaneige-Hysteresis + IceMelt + GR4J model."""

    _hyst = True
    _ice = True

    _param_list = ['CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4',
                   'DDF']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10),
                       'Thacc': (0, 1000),
                       'Rsp': (0, 1),
                       'x1': (10, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 5000),
                       'x4': (1.1, 10),
                       'DDF': (0, 30)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('Thacc', np.float64),
                       ('Rsp', np.float64),
                       ('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64),
                       ('DDF', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=None):
        super().__init__(params=params, device=device, dtype=dtype)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 sca_init=0, s_init=0, r_init=0, altitudes=[],
                 return_storage=False, params=None, mesh=None,
                 engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate the coupled hysteresis snow + ice + runoff model.

        Args as :meth:`CemaneigeHystGR4J.simulate`, plus ``frac_ice``: (L,)
        glaciated fraction of each elevation layer.

        Returns:
            qsim (T, N); with ``return_storage`` the reference-ordered
            tuple (qsim, G, eTG, s_store, r_store, sca, ice_melt,
            snowmelt, rain) (``cemaneigehystgr4jice.py:303-306``), where
            G/eTG/sca/rain are (T, L, N), snowmelt is the (T, N)
            snow-routine outflow and ice_melt is (T, N).
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init)
        return self._simulate(f, return_storage, params, mesh, engine,
                              initial_state, return_final_state)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, loss_metric="mse", snow_pack_init=0,
            thermal_state_init=0, sca_init=0, s_init=0, r_init=0,
            altitudes=[], seed=None, engine="scan", initial_state=None,
            **de_kwargs):
        """Calibrate on observed discharge with differential evolution on
        the model's device; args as :meth:`CemaneigeHystGR4J.fit`, plus
        ``frac_ice``.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init)
        return self._fit(obs, f, loss_metric, seed, engine, initial_state,
                         de_kwargs)

    def fit_Q_SCA(self, obs, prec, mean_temp, min_temp, max_temp, etp,
                  frac_ice, NDSI1, NDSI2, NDSI3, NDSI4, NDSI5,
                  met_station_height, loss_metric="mse", snow_pack_init=0,
                  thermal_state_init=0, sca_init=0, s_init=0, r_init=0,
                  altitudes=[], seed=None, engine="scan", initial_state=None,
                  pareto=False, **de_kwargs):
        """Multi-objective calibration on discharge + snow-covered area.

        Loss = ``0.75 * L(obs, qsim) + 0.05 * sum_b L(NDSI_b, 100*sca_b)``
        over the five elevation bands (reference
        ``cemaneigehystgr4jice.py:640-717``); args as
        :meth:`CemaneigeHystGR4J.fit_Q_SCA`, plus ``frac_ice``.
        ``pareto=True`` optimizes the pair ``(L_q, L_sca)`` with
        :func:`rrmpg_tpu_torch.tools.moo.nsga2` and returns the whole front.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`,
            or a :class:`~rrmpg_tpu_torch.tools.moo.ParetoResult` with
            ``pareto=True``.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, sca_init, s_init, r_init,
                          extra_series=_ndsi_series(
                              (NDSI1, NDSI2, NDSI3, NDSI4, NDSI5)))
        return self._fit_q_sca(obs, f, loss_metric, seed, engine,
                               initial_state, pareto, de_kwargs)
