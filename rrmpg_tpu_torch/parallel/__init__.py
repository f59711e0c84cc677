"""Device-mesh sharding for ensembles and regional (multi-catchment) runs.

Counterpart of ``rrmpg_tpu.parallel``: the mesh helpers (:mod:`.mesh`, with
the port's own forms described there), sharded ensembles (:mod:`.ensemble`),
the multi-process runtime (:mod:`.distributed`) and regional mode
(:mod:`.regional`).  JAX's ``relaxed_shard_map`` is JAX-specific and not
ported.
"""

from .distributed import initialize
from .ensemble import ensemble_objective, ensemble_run
from .regional import (
    regional_gr4j_objective,
    regional_run,
    regional_snow_objective,
)
from .mesh import (
    CATCHMENT_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    default_mesh,
    ensemble_catchment_mesh,
    pad_to_multiple,
    replicate,
    shard_leading_axis,
)
