"""Experiment tools: Monte-Carlo ensembles, global calibration, state
files and GLUE uncertainty bounds."""

from .calibration import (OptimizeResult, differential_evolution,
                          gradient_descent, minimize, random_search)
from .checkpoint import (load_checkpoint, load_state, save_checkpoint,
                         save_state)
from .monte_carlo import monte_carlo
from .uncertainty import glue_weights, prediction_limits
