"""kernels/_build.py from several threads: with a stub compiler (no nvcc
needed) more threads than cores that build and load the same sources at
once (the GIL switch interval shortened) compile each source once, leave
no temporary file, and get one library object."""
import os
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.kernels import _build

STUB = '''\
import pathlib, sys, time
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
src = pathlib.Path(args[-1])
with open(src.parent / "calls.log", "a") as log:
    log.write(src.stem + "\\n")
time.sleep(0.3)            # long enough for a second thread to arrive
out.write_bytes(b"built from " + src.read_bytes())
'''


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n{STUB}")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LOADED", {})
    return csrc


THREADS = 2 * (os.cpu_count() or 1) + 1


def _run_together(fn, n=THREADS):
    barrier = threading.Barrier(n)
    errors, results = [], [None] * n

    def run(i):
        barrier.wait()
        try:
            results[i] = fn()
        except BaseException as e:     # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert not errors, errors
    return results


def test_threads_build_each_source_once(stub_build):
    logs = _run_together(lambda: _build.build())
    calls = (stub_build / "calls.log").read_text().split()
    assert sorted(calls) == ["alpha", "beta"], calls
    assert sorted(name for log in logs for name in log) == ["alpha", "beta"]
    for name in ("alpha", "beta"):
        assert _build.library_path(name).read_bytes() == f"built from // {name}\n".encode()
    assert not list(_build.BUILD_DIR.glob("*.tmp"))


def test_threads_load_one_library(stub_build, monkeypatch):
    opened = []

    class FakeCDLL:
        def __init__(self, path):
            opened.append(Path(path).name)

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    libs = _run_together(lambda: _build.load("alpha"))
    assert all(lib is libs[0] for lib in libs)
    assert opened == [_build.library_path("alpha").name]
    assert (stub_build / "calls.log").read_text().split() == ["alpha"]
