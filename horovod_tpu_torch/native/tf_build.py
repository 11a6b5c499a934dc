"""Build the TF op bridge (``tf_xla_ops.cc``; counterpart: the build in
``horovod_tpu/tensorflow/_xla_bridge.py``).

The library is compiled by the host's C++ compiler (``$CXX``, else
``g++``) against the installed TensorFlow's headers and
``libtensorflow_framework`` into
``build/horovod_tpu_torch/tf-xla-<hash>/_hvd_torch_tf_xla_ops.so`` at the
root of the checkout, at first use.  The hash covers the source,
``tf.__version__``, the flags and the compiler, so another TensorFlow
gets its own build.  The build takes the directory's lock and ends with
an ``os.replace`` (``build.build_locked``), so racing ranks load one
whole file.  A failed build raises ``build.NativeBuildError`` with the
compiler's output; the JAX package falls back quietly instead.

TensorFlow is imported only when a path is asked for:
``python -m horovod_tpu_torch.native.tf_build`` builds the library and
prints its path.
"""

from __future__ import annotations

import hashlib
import os
import sys
import sysconfig
from pathlib import Path

from . import build

SOURCE = Path(__file__).resolve().parent / "tf_xla_ops.cc"
LIBRARY = "_hvd_torch_tf_xla_ops.so"
FLAGS = ["-shared", "-fPIC", "-O2", "--std=c++17",
         "-D_GLIBCXX_USE_CXX11_ABI=1", "-DEIGEN_MAX_ALIGN_BYTES=64"]


def _tf_dirs():
    """(TensorFlow's package directory, its include directory)."""
    import tensorflow as tf
    tf_dir = os.path.dirname(tf.__file__)
    return tf_dir, os.path.join(tf_dir, "include")


def artifact_path() -> Path:
    """Where the library of this source, TensorFlow, flags and compiler
    lives (built or not), under ``build.BUILD_DIR``."""
    import tensorflow as tf
    digest = hashlib.sha256(SOURCE.read_bytes())
    for part in (tf.__version__, *FLAGS, build.compiler()):
        digest.update(part.encode() + b"\0")
    return (build.BUILD_DIR / f"tf-xla-{digest.hexdigest()[:16]}"
            / LIBRARY)


def command(out: Path) -> list:
    """The compiler's command line writing the library to ``out``."""
    tf_dir, inc = _tf_dirs()
    return [build.compiler(), *FLAGS, str(SOURCE), "-o", str(out),
            f"-I{sysconfig.get_paths()['include']}", f"-I{inc}",
            f"-I{os.path.join(inc, 'external', 'highwayhash')}",
            f"-I{os.path.join(inc, 'external', 'farmhash_archive', 'src')}",
            f"-L{tf_dir}", "-l:libtensorflow_framework.so.2"]


def build_library(timeout_s: float = 900.0) -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    ``build.NativeBuildError`` with the compiler's output."""
    return build.build_locked(artifact_path(), command, SOURCE.name,
                              timeout_s)


if __name__ == "__main__":
    print(build_library())
    sys.exit(0)
