"""Host discovery for elastic training.

Counterpart: ``horovod_tpu/elastic/discovery.py``, copied (it imports no
jax).  Reference parity: ``horovod/runner/elastic/discovery.py`` — the
driver polls a user-supplied executable that prints the
currently-available hosts, one per line, as ``hostname:slots`` (or bare
``hostname`` for a default slot count).  On a cluster the script
typically wraps a scheduler query; tests use a shell script echoing a
mutable hostfile (SURVEY.md §4).

Failure semantics (docs/elastic.md): a discovery script that exits
non-zero or times out *once* is a transient flake (API hiccup, kubectl
timeout), not a cluster with zero hosts — ``HostDiscoveryScript`` returns
the last-known-good host set with a warning and only propagates the error
after ``failure_threshold`` consecutive failures (or when there is no
known-good set yet).

``NotifiedPreemptionDiscovery`` layers preemption *notices* over any
inner discovery: hosts named in a notice file (or by a callback) are
subtracted from the inner result, so the driver drains a host ahead of
the actual preemption instead of discovering the loss after the fact.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Callable, Dict, Iterable, Optional, Set

from .. import chaos as _chaos

logger = logging.getLogger("horovod_tpu_torch")

FAILURE_THRESHOLD_ENV = "HOROVOD_DISCOVERY_FAILURE_THRESHOLD"


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Current host → slot-count map (ordering is preserved)."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Discovery by user script, tolerant of transient script failures.

    A non-zero exit or timeout increments a consecutive-failure counter;
    below ``failure_threshold`` the last successful result is returned
    (with a warning) so one flaky poll cannot crash the driver or fake a
    cluster-wide host loss.  The error propagates once failures reach the
    threshold, or immediately when no successful poll has happened yet
    (there is nothing safe to return).
    """

    def __init__(self, discovery_script: str, default_slots: int = 1,
                 timeout: float = 60.0,
                 failure_threshold: Optional[int] = None):
        self.discovery_script = discovery_script
        self.default_slots = default_slots
        self.timeout = timeout
        if failure_threshold is None:
            try:
                failure_threshold = int(
                    os.environ.get(FAILURE_THRESHOLD_ENV, "3"))
            except ValueError:
                failure_threshold = 3
        self.failure_threshold = failure_threshold
        self._last_good: Optional[Dict[str, int]] = None
        self._consecutive_failures = 0

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        try:
            if _chaos.ACTIVE:
                act = _chaos.fire("discovery.find",
                                  script=self.discovery_script)
                if act is not None and act.kind == "flap":
                    # every host vanished for one poll (the discovery
                    # backend returned an empty-but-valid answer)
                    return {}
            out = subprocess.check_output(
                self.discovery_script, shell=True, timeout=self.timeout)
            hosts = parse_host_lines(out.decode(), self.default_slots)
        except Exception:  # noqa: BLE001 - script flake (exit/timeout)
            self._consecutive_failures += 1
            if (self._last_good is None
                    or self._consecutive_failures >= self.failure_threshold):
                raise
            logger.warning(
                "host discovery script failed (%d/%d consecutive); "
                "keeping last-known-good hosts %s",
                self._consecutive_failures, self.failure_threshold,
                sorted(self._last_good), exc_info=True)
            return dict(self._last_good)
        self._consecutive_failures = 0
        self._last_good = dict(hosts)
        return hosts


class FixedHostDiscovery(HostDiscovery):
    """Static host set (non-elastic fallback / unit tests)."""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class NotifiedPreemptionDiscovery(HostDiscovery):
    """Subtract hosts under a preemption notice from an inner discovery.

    Cloud preemptions are *announced* (maintenance events, a
    graceful-termination file) before the hosts die.  Point
    ``notice_file`` at a file listing doomed hostnames (one per line,
    ``#`` comments allowed; a missing file means no notices) and/or pass
    ``notice_fn`` returning an iterable of hostnames.  Hosts named by
    either source disappear from discovery results, so the elastic
    driver re-forms the job *off* a doomed host ahead of the kill
    instead of recovering from a mid-step collective failure after it.
    """

    def __init__(self, inner: HostDiscovery,
                 notice_file: Optional[str] = None,
                 notice_fn: Optional[Callable[[], Iterable[str]]] = None):
        self.inner = inner
        self.notice_file = notice_file
        self.notice_fn = notice_fn

    def preempted_hosts(self) -> Set[str]:
        doomed: Set[str] = set()
        if self.notice_file:
            try:
                with open(self.notice_file, "r") as f:
                    text = f.read()
            except OSError:
                text = ""   # no notice published
            for line in text.splitlines():
                line = line.strip()
                if line and not line.startswith("#"):
                    # tolerate "host" and "host:anything" notice formats
                    doomed.add(line.split(":", 1)[0].strip())
        if self.notice_fn is not None:
            try:
                # same normalization as notice-file lines: tolerate
                # "host" and "host:anything" from the callback too
                doomed.update(str(h).split(":", 1)[0].strip()
                              for h in self.notice_fn())
            except Exception:  # noqa: BLE001 - a broken notice callback
                # must not take discovery (and the driver) down with it
                logger.warning("preemption notice callback failed",
                               exc_info=True)
        return doomed

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        hosts = self.inner.find_available_hosts_and_slots()
        doomed = self.preempted_hosts()
        if not doomed:
            return hosts
        kept = {h: s for h, s in hosts.items() if h not in doomed}
        dropped = sorted(set(hosts) & doomed)
        if dropped:
            logger.info("preemption notice: draining hosts %s", dropped)
        return kept


def parse_host_lines(text: str, default_slots: int = 1) -> Dict[str, int]:
    hosts: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":" in line:
            name, slots = line.rsplit(":", 1)
            hosts[name.strip()] = int(slots)
        else:
            hosts[line] = default_slots
    return hosts
