"""Regional (multi-catchment) execution.

Counterpart of ``rrmpg_tpu.parallel``'s regional mode.  The device mesh
(``mesh.py``, ``ensemble.py``, ``distributed.py``: ensemble and catchment
splits across devices) is not ported yet; ``mesh=`` raises.
"""

from .regional import (
    regional_gr4j_objective,
    regional_run,
    regional_snow_objective,
)
