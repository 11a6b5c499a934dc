"""Load the native core extension (counterpart:
``horovod_tpu/native/loader.py``).

:func:`load` builds the extension at first use (``build.py``) and loads
it from its build directory; ``runtime.init`` calls it once when
``HOROVOD_TPU_NATIVE_CORE`` is on (the default) and hands the module to
the engine's planner and cache, the controller's decision, the timeline's
writer and the stall inspector's tracker.

One difference from the JAX package, deliberate: there a failed build
falls back to the Python control plane quietly.  Here it raises
:class:`NativeCoreError` at ``hvd.init()``, with the compiler's output
and the way out: ``HOROVOD_TPU_NATIVE_CORE=0`` selects the pure-Python
planner, decision, writer and tracker on purpose.
``HOROVOD_TPU_NATIVE_BUILD=0`` forbids compiling; with no artifact built
:func:`load` then raises, naming both knobs.
"""

from __future__ import annotations

import importlib.util
import sys

from ..config import _env_bool
from . import build

MODULE = "horovod_tpu_torch.native._hvd_core"

_core = None


class NativeCoreError(RuntimeError):
    """The native core could not be built or imported."""


def built() -> bool:
    """Whether this source's artifact exists (starts no compile)."""
    return build.artifact_path().exists()


def load():
    """The ``_hvd_core`` module, built first if need be; raises
    :class:`NativeCoreError` when it cannot be built or imported."""
    global _core
    if _core is not None:
        return _core
    path = build.artifact_path()
    if not path.exists():
        if not _env_bool("HOROVOD_TPU_NATIVE_BUILD", True):
            raise NativeCoreError(
                f"the native core is not built ({path}) and "
                f"HOROVOD_TPU_NATIVE_BUILD=0 forbids compiling it: build it "
                f"with `python -m horovod_tpu_torch.native.build`, unset "
                f"HOROVOD_TPU_NATIVE_BUILD, or set HOROVOD_TPU_NATIVE_CORE=0 "
                f"for the pure-Python control plane")
        try:
            path = build.build()
        except build.NativeBuildError as exc:
            raise NativeCoreError(
                f"{exc}\nSet HOROVOD_TPU_NATIVE_CORE=0 to run the "
                f"pure-Python control plane instead") from exc
    try:
        spec = importlib.util.spec_from_file_location(MODULE, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    except ImportError as exc:
        raise NativeCoreError(
            f"the native core at {path} does not import: {exc}\nSet "
            f"HOROVOD_TPU_NATIVE_CORE=0 to run the pure-Python control "
            f"plane instead") from exc
    sys.modules[MODULE] = module
    _core = module
    return module
