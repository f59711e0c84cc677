"""Build and load the port's CUDA kernels.

The sources under ``rrmpg_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source and all at once, linked into one shared library under
``build/rrmpg_tpu_torch/`` beside the package, and loaded with ``ctypes``.
The library's file name carries a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale build is never loaded.  Nothing outside the
repository's own sources is compiled, and a failed build raises with
nvcc's error output.

Nothing here runs at import time: the CPU tests import every module.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rrmpg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# GR4J objective: prec, etp, qobs, params, hist, n, t, nuh1, nuh2, stats,
# masked, count, out, device, stream
_GR4J_OBJECTIVE = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _P, _I, _P)
# GR4J regional objective (K5): prec, etp, qobs, params, counts, n, t,
# catchments, nuh1, nuh2, stats, masked, out, device, stream
_GR4J_REGIONAL = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P)
# GR4J trajectories + state: prec, etp, params, hist, n, t, nuh1, nuh2, out,
# fstate, device, stream
_GR4J_STATE = (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P)
# ABC single launch: prec, scal, n, t, scratch_int, scratch_real, qsim,
# storage, device, stream
_ABC_SINGLE = (_P, _P, _I, _L, _P, _P, _P, _P, _I, _P)
# ABC three launches: prec, scal, n, t, scratch_real, qsim, storage, device,
# stream
_ABC_CHUNKED = (_P, _P, _I, _L, _P, _P, _P, _I, _P)
# HBV trajectories: temp, prec, pe, tm, params, n, t, out, device, stream
_HBV_SIMULATE = (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P)
# HBV trajectories + state: temp, prec, pe, tm, params, n, t, warm, out,
# fstate, device, stream
_HBV_STATE = (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P)
# HBV objective: temp, prec, pe, tm, qobs, params, n, t, stats, masked,
# warm, count, out, device, stream
_HBV_OBJECTIVE = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _P, _I, _P)
# Snow trajectories: snow, rain, temp, etp, params, layer_consts, frac_ice,
# n, t, layers, nuh1, nuh2, hyst, ice, snow_only, snow0, th0, out, device,
# stream
_SNOW_SIMULATE = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  _D, _D, _P, _I, _P)
# Snow trajectories + state: snow, rain, temp, etp, params, layer_consts,
# frac_ice, state_in, hist, n, t, layers, nuh1, nuh2, hyst, ice,
# consts_per_member, snow0, th0, out, fstate, device, stream
_SNOW_STATE = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
               _I, _D, _D, _P, _P, _I, _P)
# Snow objective: snow, rain, temp, etp, qobs, ndsi, params, layer_consts,
# frac_ice, band_counts, state_in, hist, n, t, layers, nuh1, nuh2, hyst, ice,
# snow_only, stats, sca, masked, consts_per_member, snow0, th0, count, out,
# device, stream
_SNOW_OBJECTIVE = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D, _P, _I,
                   _P)
# Snow regional objective (K11): snow, rain, temp, etp, qobs, params,
# layer_consts, frac_ice, counts, n, t, layers, catchments, nuh1, nuh2, hyst,
# ice, stats, masked, snow0, th0, out, device, stream
_SNOW_REGIONAL = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _D, _D, _P, _I, _P)
_SIGNATURES = {
    "rrmpg_gr4j_split_members": (),
    "rrmpg_gr4j_traj_split_members": (),
    # prec, etp, params, n, t, nuh1, nuh2, out, device, stream
    "rrmpg_gr4j_simulate_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    "rrmpg_gr4j_simulate_f64": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    "rrmpg_gr4j_simulate_state_f32": _GR4J_STATE,
    "rrmpg_gr4j_simulate_state_f64": _GR4J_STATE,
    "rrmpg_gr4j_objective_f32": _GR4J_OBJECTIVE,
    "rrmpg_gr4j_objective_f64": _GR4J_OBJECTIVE,
    "rrmpg_gr4j_regional_objective_f32": _GR4J_REGIONAL,
    "rrmpg_gr4j_regional_objective_f64": _GR4J_REGIONAL,
    "rrmpg_abc_chunk_size": (_I,),
    "rrmpg_abc_single_f32": _ABC_SINGLE,
    "rrmpg_abc_single_f64": _ABC_SINGLE,
    "rrmpg_abc_chunked_f32": _ABC_CHUNKED,
    "rrmpg_abc_chunked_f64": _ABC_CHUNKED,
    "rrmpg_hbv_simulate_f32": _HBV_SIMULATE,
    "rrmpg_hbv_simulate_f64": _HBV_SIMULATE,
    "rrmpg_hbv_simulate_state_f32": _HBV_STATE,
    "rrmpg_hbv_simulate_state_f64": _HBV_STATE,
    "rrmpg_hbv_objective_f32": _HBV_OBJECTIVE,
    "rrmpg_hbv_objective_f64": _HBV_OBJECTIVE,
    "rrmpg_snow_max_layers": (_I, _I),
    "rrmpg_snow_simulate_f32": _SNOW_SIMULATE,
    "rrmpg_snow_simulate_f64": _SNOW_SIMULATE,
    "rrmpg_snow_simulate_state_f32": _SNOW_STATE,
    "rrmpg_snow_simulate_state_f64": _SNOW_STATE,
    "rrmpg_snow_objective_f32": _SNOW_OBJECTIVE,
    "rrmpg_snow_objective_f64": _SNOW_OBJECTIVE,
    "rrmpg_snow_regional_objective_f32": _SNOW_REGIONAL,
    "rrmpg_snow_regional_objective_f64": _SNOW_REGIONAL,
}


# The sources with dozens of kernel instantiations are optimised on several
# threads where nvcc can (``-split-compile``): the snow source, 60
# instantiations then, decided the build time, 37 s so instead of 68 s (NVIDIA
# H100 machine, 8 cores, CUDA 12.9).  The objective source (K8, and K11's 48
# instantiations since they moved there) now decides it.  The option moves a
# few register counts by one or two; the small sources build in 4 s and stay
# as they were.
SPLIT_COMPILE_SOURCES = ("gr4j_fused.cu", "snow_fused.cu", "snow_objective.cu")
SPLIT_COMPILE_THREADS = 4


def _split_compile_flags(nvcc):
    """``-split-compile N`` if this nvcc knows the option, else nothing."""
    listing = subprocess.run([nvcc, "--help"], capture_output=True,
                             text=True).stdout
    if "--split-compile" not in listing:
        return ()
    return ("-split-compile", str(SPLIT_COMPILE_THREADS))


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
    """The loaded shared library plus how it was obtained.  ``strict``
    requires every entry point of ``_SIGNATURES``; another version of the
    sources, built to be compared with this one, may lack newer ones."""

    def __init__(self, path, build_seconds, log, strict=True):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        self.log = log                       # nvcc's stderr (ptxas -v)
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            if not strict and not hasattr(self.lib, name):
                continue
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


@functools.lru_cache(maxsize=1)
def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    return build_library(SRC_DIR, BUILD_DIR)


def build_library(src_dir, build_dir, strict=True):
    """Build (if needed) and load the library of the sources in
    ``src_dir`` (``*.cu``, sharing ``*.cuh``) under ``build_dir``.  The
    port uses :func:`load_library`; another directory serves to compare
    two versions of the sources in one process (``strict=False``: an
    older version may lack newer entry points)."""
    src_dir, build_dir = Path(src_dir), Path(build_dir)
    sources = sorted(src_dir.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(src_dir.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = build_dir / f"librrmpg_kernels_{tag}.so"
    log_path = build_dir / f"librrmpg_kernels_{tag}.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return KernelLibrary(lib_path, 0.0, log, strict)

    nvcc = _find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp, \
            contextlib.ExitStack() as files:
        tmp = Path(tmp)
        # One compiler per source, all started together; each writes its
        # messages (ptxas -v) to a file of its own.
        jobs = []
        split = _split_compile_flags(nvcc)
        for src in sources:
            extra = split if src.name in SPLIT_COMPILE_SOURCES else ()
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o",
                   str(tmp / f"{src.stem}.o"), str(src)]
            messages = files.enter_context(
                open(tmp / f"{src.stem}.log", "w+"))
            jobs.append((cmd, messages, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=messages)))
        log = ""
        failures = []
        for cmd, messages, proc in jobs:
            proc.wait()
            messages.seek(0)
            text = messages.read()
            log += text
            if proc.returncode != 0:
                failures.append(f"nvcc failed (exit {proc.returncode}): "
                                f"{' '.join(cmd)}\n{text}")
        if failures:
            raise RuntimeError("\n".join(failures))
        cmd = [nvcc, "-shared", "-o", str(tmp / lib_path.name),
               *(str(tmp / f"{src.stem}.o") for src in sources)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {link.returncode}): {' '.join(cmd)}\n"
                f"{link.stderr}")
        log_path.write_text(log)
        os.replace(tmp / lib_path.name, lib_path)
    return KernelLibrary(lib_path, time.perf_counter() - t0, log, strict)
