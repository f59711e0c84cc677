"""Input validation helpers.

Same contract as ``rrmpg_tpu.utils.array_checks`` (and the reference
``rrmpg/utils/array_checks.py:15-73``): list / tuple / ndarray / tensor /
pandas.Series inputs are cast to a flat 1-D numpy array of the requested
dtype, with typed errors for bad input.  Validation runs on the host;
the model classes move the validated arrays to their device afterwards.
"""

import numpy as np
import torch


def check_for_negatives(arr) -> bool:
    """Return True if ``arr`` contains at least one negative value."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return False
    return bool(np.min(arr) < 0)


def validate_array_input(arr, dtype, arr_name: str) -> np.ndarray:
    """Check that ``arr`` is numerical and return it as a flat numpy array.

    Raises ``ValueError`` for non-numerical content and ``TypeError`` for
    unsupported container types.
    """
    import pandas as pd

    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    if not isinstance(arr, (list, tuple, np.ndarray, pd.Series)):
        raise TypeError(
            f"'{arr_name}' has unsupported type {type(arr).__name__}; pass "
            "a list, tuple, numpy array, torch tensor or pandas Series.")
    try:
        return np.array(arr, dtype=dtype).flatten()
    except (ValueError, TypeError):
        raise ValueError(
            f"Could not cast '{arr_name}' to {np.dtype(dtype).name}: "
            "it contains non-numeric entries.")
