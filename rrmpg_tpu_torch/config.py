"""Default dtype and device resolution for the PyTorch port.

float32 is the production default, as ``rrmpg_tpu.config.default_float``
gives without x64; :func:`enable_x64` makes float64 the process's default,
as JAX's does.  Every entry point's ``dtype=None`` resolves to
:func:`default_float` when it is called, and an explicit ``dtype=`` wins.
float64 runs natively on the GPU and is what the golden tests and the
JAX-parity tests use.

The card is the default device of every entry point (``DEFAULT_DEVICE``);
the CPU is asked for explicitly with ``device='cpu'``, as the CPU tests do.
Nothing moves data to the CPU when no GPU is found -- a machine without
CUDA raises unless the caller asked for the CPU.
"""

import torch

DEFAULT_DEVICE = "cuda"
DEFAULT_DTYPE = torch.float32
FLOAT_DTYPES = (torch.float32, torch.float64)

_default_float = DEFAULT_DTYPE


def enable_x64(enable: bool = True) -> None:
    """Make float64 (or, with ``enable=False``, float32 again) the default
    float type of every entry point of the port in this process.

    Counterpart of ``rrmpg_tpu.config.enable_x64``: for parity runs
    against the float64 reference.  Keep it off for production runs.
    """
    global _default_float
    _default_float = torch.float64 if enable else torch.float32


def default_float():
    """The current default float dtype (float64 iff :func:`enable_x64`)."""
    return _default_float


def resolve_device(device):
    """``torch.device(device)``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch paths.")
    return dev


def resolve_dtype(dtype):
    """``dtype`` if it is float32 or float64, :func:`default_float` for
    None; anything else raises."""
    if dtype is None:
        return default_float()
    if dtype not in FLOAT_DTYPES:
        raise TypeError(
            f"dtype must be torch.float32 or torch.float64, got {dtype}.")
    return dtype
