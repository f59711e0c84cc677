"""Experiment tools: Monte-Carlo ensembles, global calibration (DE,
SCE-UA), multi-objective calibration (NSGA-II), sensitivity analysis,
DE-MC posterior sampling, ensemble data assimilation (EnKF, particle
filter), state files and GLUE uncertainty bounds."""

from .assimilation import (assimilation_cycle, enkf_update,
                           particle_filter_update, perturb_state)
from .calibration import (OptimizeResult, differential_evolution,
                          gradient_descent, minimize, random_search)
from .sce import sce_ua
from .checkpoint import (load_checkpoint, load_state, save_checkpoint,
                         save_state)
from .mcmc import MCMCResult, demc_sample
from .monte_carlo import monte_carlo
from .moo import ParetoResult, hypervolume_2d, nsga2
from .sensitivity import (MorrisResult, SobolResult, morris_screening,
                          sobol_indices)
from .uncertainty import glue_weights, prediction_limits
