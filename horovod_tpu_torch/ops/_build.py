"""Build and load the port's CUDA kernels (counterpart: none).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, under
``build/horovod_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``.  A library's file name carries a hash of its source, of the
shared headers ``csrc/*.cuh``, of the flags and of the compiler, so an
edited source or header is rebuilt and an unchanged one is reused.  A file
lock keeps concurrent processes from building the same library twice.
Only sources in the repository are compiled.

``build_all()`` starts one ``nvcc`` for every source at once and waits for
all of them, which is how ``chip_smoke.py`` builds everything up front.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every launcher, by library: pointers and the stream are
# c_void_p so that 64-bit addresses are not cut to 32 bits
_SIGNATURES = {
    "flash_attention": {
        "hvd_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "hvd_flash_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
        "hvd_flash_dkv": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    },
    "fused_xent": {
        "hvd_xent_fwd": [_P] * 5 + [_I] * 3 + [_P],
        "hvd_xent_dh": [_P] * 5 + [_I] * 3 + [_P],
        "hvd_xent_dw": [_P] * 5 + [_I] * 3 + [_P],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
# -Xptxas -v lines (registers, shared memory, spills) of the builds this
# process ran, by library
PTXAS_REPORT: Dict[str, List[str]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built from csrc/ at first use on a machine with "
        "the CUDA toolkit")


def _library_path(name: str, compiler: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every ``csrc/*.cuh`` header it may include, and of the
    flags (include paths among them) and the compiler."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + [compiler]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Begin building ``name`` unless its library exists; returns
    ``(path, process or None, lock file)``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    path = _library_path(name, compiler)
    lock = open(BUILD_DIR / f"{name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    if path.exists():
        return path, None, lock
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, (proc, tmp), lock


def _finish(name: str, path: Path, job, lock) -> None:
    try:
        if job is None:
            return
        proc, tmp = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        PTXAS_REPORT[name] = [ln for ln in out.splitlines()
                              if "ptxas info" in ln or "spill" in ln]
        os.replace(tmp, path)
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path, job, lock = _start(name)
    _finish(name, path, job, lock)
    return _load(name, path)


def build_all() -> float:
    """Build (in parallel) and load every kernel library; returns the
    seconds it took."""
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in _SIGNATURES if n not in _LOADED]
    errors = []
    for name, path, job, lock in jobs:
        try:
            _finish(name, path, job, lock)
        except RuntimeError as e:  # report every failed build, not the first
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for name, path, _, _ in jobs:
        _load(name, path)
    return time.perf_counter() - t0


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        msg = lib.hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
