"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by ``nvcc`` alone (no PyTorch headers, so a build takes seconds)
into ``build/repro_torch/<name>-<hash>.so`` at the repository root.  The
hash covers the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt.
Nothing is built when a module is imported: the first wrapper call on a
CUDA tensor (or :func:`build`) does it.  Building and loading hold one
process-wide lock, so threads that reach a kernel at the same time (the
serving engine's support and dense stages) build each library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# No --use_fast_math, and no FMA contraction: the dense energy must round
# each float operation on its own to give the plain version's bits.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Serialises build() and load() across threads; re-entrant because load()
# builds while holding it.
_LOCK = threading.RLock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built only "
            "where the CUDA toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    """Where the shared library for ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every library in ``names`` (default: all sources) that is not
    built yet, one ``nvcc`` per source, all started together.

    Returns ``{name: compiler output}`` for the sources compiled by this
    call (``-Xptxas -v`` reports registers and shared memory per kernel).
    """
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: list[str] | None) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names or sources():
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs[name] = (proc, tmp, out)
        logs = {}
        for name, (proc, tmp, out) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
            os.replace(tmp, out)     # atomic: a concurrent process never loads half a file
            logs[name] = text
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed
    (once per process, whichever thread asks first)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def bind(name: str, symbol: str, argtypes: list):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, typed: pointer and
    stream arguments must be ``c_void_p`` (ctypes would pass a bare int as
    32 bits), and every launcher returns its ``cudaError_t`` as an int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
