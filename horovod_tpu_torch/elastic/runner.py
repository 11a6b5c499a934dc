"""The elastic run-loop decorator.

Counterpart: ``horovod_tpu/elastic/runner.py``; reference parity:
``horovod/common/elastic.py`` ``run_fn`` (SURVEY.md §3.5)::

    @hvd.elastic.run
    def train(state, ...): ...

The wrapper catches a collective failure (``HorovodInternalError``, or
the transport errors of ``torch.distributed`` when a peer dies under a
collective the model issues itself) → ``state.restore()`` + re-init, and
``HostsUpdatedInterrupt`` (discovery delta) → ``state.sync()``, then
re-enters the function.  ``reset_limit`` bounds consecutive resets.
"""

from __future__ import annotations

import functools
import logging
import os

import torch.distributed as dist

from ..exceptions import HorovodInternalError, HostsUpdatedInterrupt

logger = logging.getLogger("horovod_tpu_torch")

#: torch.distributed's errors of a lost peer or store: recoverable by
#: re-rendezvous whatever their message
_TRANSPORT_ERRORS = (dist.DistBackendError, dist.DistStoreError,
                     dist.DistNetworkError)

# A plain RuntimeError is gloo's when its message names gloo (gloo's errors
# carry their source path, ".../gloo/transport/tcp/pair.cc"), and a lost
# peer's when it also carries one of these markers.  Anything else — OOM,
# a shape mismatch, a user's own RuntimeError with the same words — is
# deterministic and must surface, not loop re-forms (the reference's rule:
# a transport name or status prefix, and a marker).
_TRANSPORT_MARKERS = (
    "connection closed by peer", "connection reset by peer",
    "socket timeout", "timed out", "broken pipe", "connection refused",
)


def _is_recoverable(exc) -> bool:
    if isinstance(exc, (HorovodInternalError,) + _TRANSPORT_ERRORS):
        return True
    if type(exc) is RuntimeError:
        msg = str(exc).lower()
        return "gloo" in msg and any(m in msg for m in _TRANSPORT_MARKERS)
    return False


def run(func=None, *, reset_limit: int = None):
    if func is None:
        return functools.partial(run, reset_limit=reset_limit)

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from . import worker
        notification_manager = _get_notification_manager()
        if notification_manager is not None:
            notification_manager.register_listener(state)
        if worker._last_epoch > 0:
            # this worker joined a mid-flight job (spawned at epoch > 0 by
            # the driver): receive current state before training — the
            # incumbents' HostsUpdatedInterrupt path issues the matching
            # sync on their side
            logger.info("joined elastic job at epoch %d; syncing state",
                        worker._last_epoch)
            state._fresh = True   # the others' state wins this sync
            try:
                state.sync()
            finally:
                state._fresh = False
        reset_count = 0
        try:
            while True:
                if reset_count > 0:
                    state.on_reset()
                try:
                    result = func(state, *args, **kwargs)
                    worker.record_result("SUCCESS")
                    return result
                except HostsUpdatedInterrupt as e:
                    logger.info("hosts updated; syncing state")
                    state.evacuate()
                    _reinitialize()
                    _sync_after_reset(state, skip_sync=e.skip_sync)
                except Exception as e:  # noqa: BLE001 - the type and the
                    # transport markers decide, see _is_recoverable
                    if not _is_recoverable(e):
                        raise  # deterministic error (OOM, bad arg, …)
                    logger.warning(
                        "collective failure (%s: %s); restoring last "
                        "committed state and re-initializing",
                        type(e).__name__, e)
                    state.evacuate()
                    # no process may have died and discovery may be
                    # unchanged — ask the driver for a fresh epoch
                    worker.request_reform()
                    _reinitialize()
                    # the failed step may have half-applied an update:
                    # back to the commit, then agree with the new world
                    state.restore()
                    _sync_after_reset(state, skip_sync=False)
                reset_count += 1
                if reset_limit is not None and reset_count > reset_limit:
                    raise RuntimeError(
                        f"exceeded elastic reset limit ({reset_limit})")
        except BaseException:
            worker.record_result("FAILURE")
            raise
        finally:
            if notification_manager is not None:
                notification_manager.remove_listener(state)

    return wrapper


def _reinitialize():
    """Tear down and re-init the runtime so its world reflects the new
    membership (reference: shutdown + init with HOROVOD_ELASTIC reset),
    on the device the first ``init`` was given.  Peers that died are not
    waited for (``runtime.shutdown``'s elastic teardown)."""
    from .. import runtime
    runtime.shutdown()
    runtime.init(device=runtime.last_init_device())


def _sync_after_reset(state, skip_sync: bool):
    if not skip_sync:
        state.sync()


_notification_manager = None


def _get_notification_manager():
    """The worker's host-update listener; auto-created under the elastic
    driver (HOROVOD_ELASTIC_DRIVER_ADDR set by driver spawn)."""
    global _notification_manager
    if (_notification_manager is None
            and os.environ.get("HOROVOD_ELASTIC_DRIVER_ADDR")):
        from .worker import WorkerNotificationManager
        mgr = WorkerNotificationManager()
        try:
            mgr.init()
        except Exception:  # noqa: BLE001 - driver unreachable; run solo
            logger.warning("could not register with elastic driver",
                           exc_info=True)
            mgr.close()
            return None
        _notification_manager = mgr
    return _notification_manager
