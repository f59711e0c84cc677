"""Cemaneige + GR4J coupled model interface class.

Counterpart of ``rrmpg_tpu.models.cemaneigegr4j.CemaneigeGR4J``: six
parameters (CTG, Kf, x1..x4), same ``simulate``/``fit`` signatures,
validation errors and output shapes, with ``engine='scan'|'fused'`` in place
of ``'xla'|'pallas'`` (see :mod:`._snow_base`).
"""

import numpy as np

from ..config import DEFAULT_DEVICE
from ._snow_base import SnowGR4JBase


class CemaneigeGR4J(SnowGR4JBase):
    """Interface to the Cemaneige + GR4J coupled model."""

    _param_list = ['CTG', 'Kf', 'x1', 'x2', 'x3', 'x4']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10),
                       'x1': (100, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 300),
                       'x4': (1.1, 2.9)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=None):
        super().__init__(params=params, device=device, dtype=dtype)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 s_init=0, r_init=0, altitudes=[], return_storage=False,
                 params=None, mesh=None, engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate the coupled snow + runoff model.

        Args:
            prec: (T,) daily precipitation sum [mm].
            mean_temp, min_temp, max_temp: (T,) daily temperatures [C].
            etp: (T,) potential evapotranspiration [mm].
            met_station_height: station elevation [m].
            snow_pack_init, thermal_state_init: initial snow states.
            s_init, r_init: GR4J store fillings as fractions, in [0, 1].
            altitudes: (optional) list of median layer elevations [m].
            return_storage: also return G, eTG, s_store, r_store ('scan'
                only).
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.
            mesh: (optional) :class:`~..parallel.mesh.Mesh`; the
                members (and a warm state) are split over its 'ensemble'
                axis, ``engine='scan'`` only.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K9,
                discharge only, single-device).

        Returns:
            qsim (T, N); plus G (T, L, N), eTG (T, L, N), s_store (T, N),
            r_store (T, N) if ``return_storage``; tensors on the model's
            device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If there is a size mismatch between the
                meteorological input arrays.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, None,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, 0, s_init, r_init)
        return self._simulate(f, return_storage, params, mesh, engine,
                              initial_state, return_final_state)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp,
            met_station_height, snow_pack_init=0, thermal_state_init=0,
            s_init=0, r_init=0, altitudes=[], loss_metric="mse", seed=None,
            engine="scan", initial_state=None, **de_kwargs):
        """Calibrate on observed discharge with differential evolution on
        the model's device.

        Args:
            obs: observed discharge; NaN marks a gap.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            engine: 'scan', or 'fused' to evaluate every DE generation with
                one launch of the fused objective kernel K8.
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize` and on to
                ``differential_evolution``: ``key``, ``popsize``, ``maxiter``,
                ``tol``, ``checkpoint_path`` / ``checkpoint_every`` /
                ``resume_from`` (``*.npz`` or a directory), ``polish`` /
                ``polish_steps`` (skipped, with a note in the message, on the
                fused kernels, which have no backward); ``mesh`` /
                ``mesh_axis`` (each generation's population split over the
                mesh).

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        f = self._prepare(prec, mean_temp, min_temp, max_temp, etp, None,
                          met_station_height, altitudes, snow_pack_init,
                          thermal_state_init, 0, s_init, r_init)
        return self._fit(obs, f, loss_metric, seed, engine, initial_state,
                         de_kwargs)
