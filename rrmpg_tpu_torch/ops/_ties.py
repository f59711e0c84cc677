"""Clamps whose gradient at a bound is JAX's.

``torch.clamp`` passes the whole gradient to its input where the input
equals a bound; ``jnp.maximum`` / ``jnp.minimum`` (and ``jnp.clip``, built
from them) pass half of it, as ``torch.maximum`` / ``torch.minimum`` do.
The ``'scan'`` engine clamps with these, so that its gradients equal the
JAX package's where a value sits on a bound (a store that starts at its
threshold, a whole-number x4 in the unit hydrographs).  The values are
``torch.clamp``'s.
"""

import torch


def clamp_min0(x):
    """``max(x, 0)``."""
    return torch.maximum(x, x.new_zeros(()))


def clamp_max0(x):
    """``min(x, 0)``."""
    return torch.minimum(x, x.new_zeros(()))


def clamp01(x):
    """``min(max(x, 0), 1)``."""
    return torch.minimum(clamp_min0(x), x.new_ones(()))
