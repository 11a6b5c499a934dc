"""hvdchaos: deterministic fault injection for the coordination planes.

The elastic layer exists to survive worker churn, flaky discovery, and
lost control-plane messages — failure classes that show up on real
hardware at the worst possible time and almost never in CI.  This
subsystem *provokes* them deterministically: a seeded
:class:`~horovod_tpu_torch.chaos.schedule.FaultSchedule` of declarative rules
(``rpc.request:running nth=1 action=drop``) decides, at instrumented
injection points threaded through the RPC transport, the coordination KV
client, the elastic lifecycle, discovery, and the engine cycle loop,
whether to drop/delay/duplicate/fail that operation.  The same seed and
rule set reproduce the same fault sequence every run, turning "rare
mid-session flake" into a pinned regression test.

Usage::

    import horovod_tpu_torch.chaos as chaos
    sched = chaos.FaultSchedule.parse(
        "rpc.request:hosts_updated nth=1 action=drop", seed=7)
    chaos.install(sched)
    ...   # run the scenario
    sched.fired       # exactly which faults were injected
    chaos.uninstall()

or from the environment (inherited by driver-spawned workers)::

    HVD_CHAOS='rpc.request prob=0.1 action=delay:0.05' HVD_CHAOS_SEED=3 ...
    HVD_CHAOS=@/path/to/schedule.json ...

Zero overhead when disabled: every injection point is guarded by the
module-level :data:`ACTIVE` flag —

    ``if _chaos.ACTIVE: _chaos.fire("site", key=val)``

— one attribute load and a false branch on the hot path, nothing else.
:func:`fire` is only ever reached with a schedule installed.

Injection sites and the actions each caller honors are cataloged in
``docs/env.md`` ("Chaos engineering").  Action semantics:

* ``delay[:secs]``  — sleep (default 0.05 s), then proceed normally
* ``drop``          — raise :class:`ChaosConnectionError` (transport
  loss; retried by the RPC retry path)
* ``reset``         — raise :class:`ChaosConnectionReset`
* ``http500``       — raise ``urllib.error.HTTPError`` 500 (server-side
  fault as seen by an RPC client)
* ``error[:msg]``   — raise :class:`ChaosError` (generic transient)
* ``crash[:code]``  — ``os._exit`` the process (default code 17)
* ``dup``/``stale``/``flap``/``drop-reply`` — returned to the injection
  point, which interprets them (duplicate send, stale KV read, empty
  discovery, server runs the handler then swallows the reply)
* ``nan[:R]``/``scale[:R[,F]]`` — returned to the ``collective.corrupt``
  site (``health/taps.py``): rank R's contribution to the matched
  fusion bucket becomes NaN / is scaled by F — the deterministic
  value-corruption the training-health evaluator is tested against

Counterpart: ``horovod_tpu/chaos/__init__.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import logging
import os
import time
import urllib.error
from typing import Optional

from .. import metrics as _metrics
from .schedule import Action, FaultRule, FaultSchedule  # noqa: F401

logger = logging.getLogger("horovod_tpu_torch")

# chaos→metrics bridge: injections counted per RULE so a fault seed can
# be asserted to have actually fired (a silently inert HVD_CHAOS rule
# otherwise passes CI stage 9 without injecting anything)
_m_injections = _metrics.counter(
    "hvd_chaos_injections_total", "Chaos injections fired, by rule",
    labels=("rule", "site", "action"))

ENV_SPEC = "HVD_CHAOS"
ENV_SEED = "HVD_CHAOS_SEED"

#: Hot-path guard. Injection points read this module attribute before
#: calling :func:`fire`; False (the default) costs one branch.
ACTIVE = False

_SCHEDULE: Optional[FaultSchedule] = None


class ChaosError(RuntimeError):
    """Generic injected fault (``action=error``)."""


class ChaosConnectionError(ConnectionError):
    """Injected transport loss (``action=drop``).  A ``ConnectionError``
    so the RPC retry path treats it exactly like a real network drop."""


class ChaosConnectionReset(ConnectionResetError):
    """Injected connection reset (``action=reset``)."""


def install(schedule: FaultSchedule):
    """Activate ``schedule`` process-wide (replaces any previous one)."""
    global _SCHEDULE, ACTIVE
    _SCHEDULE = schedule
    ACTIVE = True
    logger.info("chaos: fault schedule installed (seed=%d, %d rules)",
                schedule.seed, len(schedule.rules))


def uninstall():
    """Deactivate fault injection; injection points become no-ops."""
    global _SCHEDULE, ACTIVE
    ACTIVE = False
    _SCHEDULE = None


def current() -> Optional[FaultSchedule]:
    return _SCHEDULE


def from_env(environ=os.environ) -> Optional[FaultSchedule]:
    """Build a schedule from ``HVD_CHAOS`` / ``HVD_CHAOS_SEED``, or None.

    ``HVD_CHAOS`` holds an inline spec (rule text or JSON) or
    ``@/path/to/file`` whose contents are the spec.  A malformed spec
    raises ``ValueError`` — a chaos run with a typo'd schedule must fail
    loudly, not silently run fault-free.
    """
    spec = environ.get(ENV_SPEC)
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:], "r") as f:
            spec = f.read()
    try:
        seed = int(environ.get(ENV_SEED, "0"))
    except ValueError:
        raise ValueError(f"{ENV_SEED} must be an integer") from None
    return FaultSchedule.parse(spec, seed=seed)


def fire(site: str, _defer=(), **ctx) -> Optional[Action]:
    """Evaluate the installed schedule at an injection point.

    Executes self-contained actions (``delay`` sleeps; ``drop``/
    ``reset``/``http500``/``error`` raise; ``crash`` exits the process)
    and returns caller-interpreted ones (``dup``/``stale``/``flap``).
    Returns None when no rule fires.

    ``_defer`` lists action kinds the CALLER interprets at this site
    instead of having them executed here: sites that model the fault
    rather than suffer it (``collective.dcn`` turns ``delay`` into a
    per-host arrival lateness the tail-policy deadline gate reasons
    about — sleeping inside fire() would bypass the very deadline under
    test) receive the fired :class:`Action` back unexecuted.
    """
    sched = _SCHEDULE
    if sched is None:
        return None
    act = sched.decide(site, ctx)
    if act is None:
        return None
    logger.info("chaos: %s at %s %s", act.kind, site, ctx)
    if _metrics.ACTIVE:
        _m_injections.inc(rule=act.rule, site=site, action=act.kind)
    if _metrics.RECORDING:
        _metrics.event("chaos.injection", site=site, action=act.kind,
                       rule=act.rule)
    kind = act.kind
    if kind in _defer:
        return act
    if kind == "delay":
        time.sleep(act.arg_float(0.05))
        return None
    if kind == "drop":
        raise ChaosConnectionError(f"chaos: dropped at {site} ({ctx})")
    if kind == "reset":
        raise ChaosConnectionReset(f"chaos: reset at {site} ({ctx})")
    if kind == "http500":
        raise urllib.error.HTTPError(
            f"chaos://{site}", 500, "chaos injected server error",
            None, None)
    if kind == "error":
        raise ChaosError(act.arg or f"chaos: error at {site} ({ctx})")
    if kind == "crash":
        logger.warning("chaos: crashing process at %s", site)
        os._exit(act.arg_int(17))
    return act


# Workers spawned by the elastic driver inherit HVD_CHAOS through the
# spawn environment; installing at import means every process in the job
# runs the same schedule without explicit wiring.
if os.environ.get(ENV_SPEC):
    install(from_env())
