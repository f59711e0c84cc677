"""Repository-level test set-up: build the C++ oracle once, before any
worker starts.

``rrmpg_tpu/native`` compiles ``oracle.cpp`` into ``liboracle.so`` at first
use, in place and without a lock.  Under pytest-xdist every worker probes
the library while it collects, so several workers could compile into the
same file at once, and a worker that loaded a half-written library skipped
its oracle tests.  Here the controller (the only process without
``workerinput``) builds the library once, into a temporary name in the
same directory that ``os.replace`` then moves into place, and only where
it is missing or older than its source; the workers find it up to date and
only load it.  Without ``g++`` nothing is built and the oracle tests skip
as before.

This file imports nothing of ``rrmpg_tpu``: that package imports JAX,
which ``tests/conftest.py`` must configure first.
"""

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

ORACLE_DIR = Path(__file__).resolve().parent / "rrmpg_tpu" / "native"


def build_shared_library(src, lib, compiler="g++"):
    """Compile the C++ source ``src`` into the shared library ``lib``
    (with the flags of ``rrmpg_tpu/native``) unless ``lib`` exists and is
    not older than ``src``.  The compiler writes a temporary file beside
    ``lib``, which then replaces ``lib`` in one step, so no process ever
    loads a half-written library.  Returns True if it built, False if the
    library was up to date; raises ``CalledProcessError`` if the compiler
    fails."""
    src, lib = Path(src), Path(lib)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return False
    fd, tmp = tempfile.mkstemp(prefix=f".{lib.name}.", suffix=".tmp",
                               dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run([compiler, "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(src), "-o", tmp], check=True,
                       capture_output=True)
        os.chmod(tmp, 0o755)  # mkstemp made it private to its owner
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: only load
        return
    if shutil.which("g++") is None:
        return
    try:
        build_shared_library(ORACLE_DIR / "oracle.cpp",
                             ORACLE_DIR / "liboracle.so")
    except (OSError, subprocess.CalledProcessError):
        pass  # the oracle's own probe reports it and its tests skip
