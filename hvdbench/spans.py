"""The port's own step spans, read from its span ring.

The port records a ``step`` span (category ``step``) for each call of the
steps the cells run, with ``profiled`` (a torch profiler recorded when the
step began) and the step's own ``wait_ms``, ``queue_ms`` and ``gc_ms``
(``horovod_tpu_torch.tracing.steps``).  The ring is the process's default
span buffer; it outlives ``hvd.shutdown()``, so a reader takes it after
the run.  The readers of ``engine.wait_ms``, ``engine.queue_ms`` and
``host.gc_ms`` use the window's steps from it: the newest unprofiled
step spans, at most as many as the window ran.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

#: a reader needs at least this many of the window's steps
MIN_STEPS = 3
#: the port's module that records the step spans
STEPS_MODULE = "horovod_tpu_torch.tracing.steps"


def ring() -> Optional[Dict]:
    """A snapshot of the port's span ring; None where the port has no
    :data:`STEPS_MODULE`, so records no step span."""
    if importlib.util.find_spec(STEPS_MODULE) is None:
        return None
    from horovod_tpu_torch import tracing
    return tracing.buffer().snapshot()


def window_steps(n: int) -> Optional[List[Dict]]:
    """The newest unprofiled ``step`` spans of the port's ring, at most
    ``n``, oldest first.  A step that ran while a capture warmed up
    (recording not yet on) reads unprofiled too, so the unprofiled step
    right before a profiled one is left out.  None where the port records
    no step span (:func:`ring`); raises where fewer than
    :data:`MIN_STEPS` remain, none at all included."""
    snap = ring()
    if snap is None:
        return None
    steps = sorted((s for s in snap["spans"]
                    if s["cat"] == "step" and s["name"] == "step"),
                   key=lambda s: s["t0"])
    profiled = [bool(s["args"]["profiled"]) for s in steps] + [False]
    kept = [s for i, s in enumerate(steps)
            if not profiled[i] and not profiled[i + 1]][-n:]
    if len(kept) < MIN_STEPS:
        raise LookupError(
            f"{len(kept)} unprofiled step spans in the port's span ring "
            f"({len(steps)} step spans, {snap.get('dropped', 0)} spans "
            f"dropped); a reader needs {MIN_STEPS}")
    return kept
