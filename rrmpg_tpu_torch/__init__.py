# This file is part of rrmpg-tpu's PyTorch port: the same conceptual
# rainfall-runoff models, metrics, Monte-Carlo and calibration tools as
# ``rrmpg_tpu``, written in PyTorch, with the fused ensemble kernels
# written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).
#
# ``rrmpg_tpu`` (JAX / Pallas) stays the reference; every module here
# keeps its counterpart's name so the two can be read side by side.
# This package never imports JAX.
#
# Licensed under the MIT License.

__version__ = "0.1.0"

from . import config
from . import data
from . import models
from . import ops
from . import parallel
from . import tools
from . import utils
