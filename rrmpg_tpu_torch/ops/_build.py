"""Build and load the port's CUDA kernels.

The sources under ``rrmpg_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library under ``build/rrmpg_tpu_torch/`` beside the package,
and loaded with ``ctypes``.  The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale build
is never loaded.  Nothing outside the repository's own sources is
compiled, and a failed build raises with nvcc's error output.

Nothing here runs at import time: the CPU tests import every module.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rrmpg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # prec, etp, params, n, t, nuh1, nuh2, out, device, stream
    "rrmpg_gr4j_simulate_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    "rrmpg_gr4j_simulate_f64": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    # prec, etp, qobs, params, n, t, nuh1, nuh2, stats, masked, count,
    # out, device, stream
    "rrmpg_gr4j_objective_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 ctypes.c_double, _P, _I, _P),
    "rrmpg_gr4j_objective_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 ctypes.c_double, _P, _I, _P),
}


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
            "/usr/local/cuda/bin); the fused kernels need the CUDA toolkit.")
    return nvcc


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path, build_seconds, log):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        self.log = log                       # nvcc's stderr (ptxas -v)
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


@functools.lru_cache(maxsize=1)
def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"librrmpg_kernels_{tag}.so"
    log_path = BUILD_DIR / f"librrmpg_kernels_{tag}.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return KernelLibrary(lib_path, 0.0, log)

    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_path), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    log_path.write_text(proc.stderr)
    os.replace(tmp_path, lib_path)
    return KernelLibrary(lib_path, seconds, proc.stderr)
