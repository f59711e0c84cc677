"""Experiment tools: Monte-Carlo ensembles and global calibration."""

from .calibration import OptimizeResult, differential_evolution, minimize
from .monte_carlo import monte_carlo
