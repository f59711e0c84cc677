"""The repository conftest's build of the C++ oracle, on a tiny source.

The root ``conftest.py`` builds ``rrmpg_tpu/native/liboracle.so`` once on
the xdist controller, through a temporary file that ``os.replace`` moves
into place, so that no worker compiles it or loads it half-written.  These
tests run that helper on a one-function C++ source in ``tmp_path``.
"""

import ctypes
import importlib.util
import os
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SOURCE = """
extern "C" int answer(int x) { return 2 * x + 1; }
"""


def _root_conftest():
    """The root conftest as a module of its own name (``conftest`` is
    taken by ``tests/conftest.py``)."""
    spec = importlib.util.spec_from_file_location("_root_conftest",
                                                  ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def helper():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _root_conftest().build_shared_library


@pytest.fixture
def source(tmp_path):
    src = tmp_path / "tiny.cpp"
    src.write_text(SOURCE)
    return src


def test_root_conftest_imports_no_jax_package():
    text = (ROOT / "conftest.py").read_text()
    assert "import rrmpg_tpu" not in text and "from rrmpg_tpu" not in text
    assert "import jax" not in text


def test_builds_through_a_temporary_name_and_replace(helper, source,
                                                     monkeypatch):
    lib = source.with_name("libtiny.so")
    moves = []
    real_replace = os.replace

    def spy(src, dst):
        moves.append((Path(src), Path(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    assert helper(source, lib) is True
    assert len(moves) == 1
    tmp, dst = moves[0]
    assert dst == lib and tmp.parent == lib.parent and tmp != lib
    assert not tmp.exists()
    # Nothing but the source and the library is left in the directory.
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        "libtiny.so", "tiny.cpp"]


def test_result_loads_with_ctypes(helper, source):
    lib = source.with_name("libtiny.so")
    helper(source, lib)
    loaded = ctypes.CDLL(str(lib))
    loaded.answer.argtypes = (ctypes.c_int,)
    loaded.answer.restype = ctypes.c_int
    assert loaded.answer(20) == 41


def test_up_to_date_library_is_not_rebuilt(helper, source):
    lib = source.with_name("libtiny.so")
    assert helper(source, lib) is True
    before = lib.stat().st_mtime_ns
    assert helper(source, lib) is False
    assert lib.stat().st_mtime_ns == before


def test_library_older_than_its_source_is_rebuilt(helper, source):
    lib = source.with_name("libtiny.so")
    helper(source, lib)
    old = source.stat().st_mtime - 100
    os.utime(lib, (old, old))
    assert helper(source, lib) is True
    assert lib.stat().st_mtime >= source.stat().st_mtime


def test_failed_build_leaves_no_library(helper, tmp_path):
    import subprocess

    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++")
    lib = tmp_path / "libbroken.so"
    with pytest.raises(subprocess.CalledProcessError):
        helper(src, lib)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["broken.cpp"]


def test_controller_builds_and_workers_only_load(tmp_path, monkeypatch):
    """pytest_configure builds on the controller and does nothing on an
    xdist worker (a config with ``workerinput``)."""
    module = _root_conftest()
    calls = []
    monkeypatch.setattr(module, "build_shared_library",
                        lambda src, lib: calls.append((src, lib)))
    monkeypatch.setattr(module.shutil, "which", lambda name: "/bin/g++")

    class Config:
        pass

    worker = Config()
    worker.workerinput = {"workerid": "gw0"}
    module.pytest_configure(worker)
    assert calls == []
    module.pytest_configure(Config())
    assert calls == [(module.ORACLE_DIR / "oracle.cpp",
                      module.ORACLE_DIR / "liboracle.so")]
