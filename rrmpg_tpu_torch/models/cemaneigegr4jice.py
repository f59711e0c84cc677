"""Cemaneige + degree-day ice melt + GR4J coupled model interface class.

Counterpart of ``rrmpg_tpu.models.cemaneigegr4jice.CemaneigeGR4JIce``:
seven parameters (CTG, Kf, x1..x4, DDF) and the ``frac_ice`` glacier
fractions, same ``simulate``/``fit`` signatures, with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'`` (see
:mod:`._snow_base`).
"""

import numpy as np

from ..config import DEFAULT_DEVICE, DEFAULT_DTYPE
from ._snow_base import SnowGR4JBase


class CemaneigeGR4JIce(SnowGR4JBase):
    """Interface to the Cemaneige + IceMelt + GR4J coupled model."""

    _ice = True

    _param_list = ['CTG', 'Kf', 'x1', 'x2', 'x3', 'x4', 'DDF']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (1, 15),
                       'x1': (100, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 300),
                       'x4': (1.1, 2.9),
                       'DDF': (1, 30)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64),
                       ('DDF', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=DEFAULT_DTYPE):
        super().__init__(params=params, device=device, dtype=dtype)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 s_init=0, r_init=0, altitudes=[], return_storage=False,
                 params=None, mesh=None, engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate the coupled snow + ice + runoff model.

        Args as :meth:`CemaneigeGR4J.simulate`, plus ``frac_ice``: (L,)
        glaciated fraction of each elevation layer.

        Returns:
            qsim (T, N); plus (G, eTG, s_store, r_store, ice_melt) if
            ``return_storage`` (reference order,
            ``cemaneigegr4jice.py:285-288``), ice_melt of shape (T, N).
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, 0, s_init, r_init)
        return self._simulate(f, return_storage, params, mesh, engine,
                              initial_state, return_final_state)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, snow_pack_init=0, thermal_state_init=0,
            s_init=0, r_init=0, altitudes=[], loss_metric="mse", seed=None,
            engine="scan", initial_state=None, **de_kwargs):
        """Calibrate on observed discharge with differential evolution on
        the model's device; args as :meth:`CemaneigeGR4J.fit`, plus
        ``frac_ice``.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, 0, s_init, r_init)
        return self._fit(obs, f, loss_metric, seed, engine, initial_state,
                         de_kwargs)
