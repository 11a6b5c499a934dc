"""Build the native core extension (counterpart:
``horovod_tpu/native/build.py``).

``core.cpp`` is compiled by the host's C++ compiler (``$CXX``, else
``g++``) against the interpreter's ``Python.h`` into
``build/horovod_tpu_torch/native-<hash>/_hvd_core<EXT_SUFFIX>`` at the
root of the checkout, at first use.  The hash covers the source, the
flags, the include directory, the compiler and ``EXT_SUFFIX``, so an
edited source is rebuilt and an unchanged one reused.  The file's base
name is fixed by ``PyInit__hvd_core``, so the hash names the directory.

Several processes may build at once (test workers, spawned ranks): an
``fcntl`` lock serialises them, the compiler writes a temporary name and
``os.replace`` moves it into place, so no process loads a half-written
library.  A failed build raises :class:`NativeBuildError` with the
compiler's output.

``python -m horovod_tpu_torch.native.build`` builds it and prints the
path.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
FLAGS = ["-std=c++17", "-O2", "-fPIC", "-fvisibility=hidden", "-shared"]


class NativeBuildError(RuntimeError):
    """The compiler failed or could not run; the message carries its
    output."""


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def include_dir() -> str:
    return sysconfig.get_paths()["include"]


def ext_suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def artifact_path() -> Path:
    """Where the extension of this source, flags, compiler and
    interpreter lives (built or not)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    cxx = compiler()
    for part in (*FLAGS, include_dir(), cxx, shutil.which(cxx) or "",
                 ext_suffix()):
        digest.update(part.encode() + b"\0")
    return (BUILD_DIR / f"native-{digest.hexdigest()[:16]}"
            / f"_hvd_core{ext_suffix()}")


def build(timeout_s: float = 300.0) -> Path:
    """Compile the extension unless it exists; returns its path.  Raises
    :class:`NativeBuildError` when the compiler fails or cannot run, and
    when the build directory cannot be made, locked or written."""
    path = artifact_path()
    if path.exists():
        return path
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path.parent / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():  # another process built it while we waited
                return path
            _compile(path, timeout_s)
    except OSError as exc:
        raise NativeBuildError(
            f"could not build {SOURCE.name} into {path.parent}: {exc}"
        ) from exc
    return path


def _compile(path: Path, timeout_s: float):
    """Compile to a temporary name beside ``path`` and move it there."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [compiler(), *FLAGS, f"-I{include_dir()}", str(SOURCE),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"could not run the C++ compiler ({' '.join(cmd)}): "
            f"{exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"the C++ compiler failed to build {SOURCE.name} (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


if __name__ == "__main__":
    print(build())
    sys.exit(0)
