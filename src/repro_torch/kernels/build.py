"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``), for ``sm_90a``, with a plain C
interface that :func:`library` loads through ``ctypes``.  The hash
covers every file under ``csrc/`` (a source and whatever it includes)
and the flags, so an edited kernel or header rebuilds.  No CUTLASS or
CuTe header is used, so no ``-I`` flag is passed.  :func:`function`
binds an entry point's argument types once, when it is first asked for.
:func:`build_all` starts every ``nvcc`` at once and waits for all of
them.  Nothing here runs when a module is imported: the CPU tests
import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("flash_attention", "paged_attention", "admit_quantum")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
#: name → (seconds, ptxas report) of builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(name.encode())
    for path in sorted(CSRC.rglob("*")):
        if path.is_file():
            digest.update(path.relative_to(CSRC).as_posix().encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no current library, with
    one ``nvcc`` per source running in parallel.  Returns name → path."""
    started = {n: _start(n) for n in KERNEL_SOURCES}
    for name, s in started.items():
        if s is not None:
            _finish(name, s)
    return {n: _target(n) for n in KERNEL_SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        s = _start(name)
        if s is not None:
            _finish(name, s)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``csrc/<name>.cu``, returning a
    ``cudaError_t`` as an int; its argument types are set on the first
    call only (launches sit on the host-bound decode step)."""
    fn = _FNS.get((name, entry))
    if fn is None:
        fn = getattr(library(name), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(name, entry)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError_t {err}")
