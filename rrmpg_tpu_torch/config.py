"""Default dtype and device resolution for the PyTorch port.

float32 is the production default, as ``rrmpg_tpu.config.default_float``
gives without x64.  float64 runs natively on the GPU and is what the
golden tests and the JAX-parity tests use.

Every entry point takes an explicit ``device``; nothing moves data to the
CPU when no GPU is found -- asking for CUDA without one raises.
"""

import torch

DEFAULT_DTYPE = torch.float32
FLOAT_DTYPES = (torch.float32, torch.float64)


def resolve_device(device):
    """``torch.device(device)``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch paths.")
    return dev


def resolve_dtype(dtype):
    """Return ``dtype`` if it is float32 or float64, else raise."""
    if dtype not in FLOAT_DTYPES:
        raise TypeError(
            f"dtype must be torch.float32 or torch.float64, got {dtype}.")
    return dtype
