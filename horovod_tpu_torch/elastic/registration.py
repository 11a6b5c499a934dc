"""Worker state registry for the elastic driver.

Counterpart: ``horovod_tpu/elastic/registration.py``, copied (it imports
no jax).  Reference parity: ``horovod/runner/elastic/registration.py``
``WorkerStateRegistry`` — tracks each worker's terminal state per epoch
and per-host failure counts feeding the blacklist.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, blacklist_threshold: int = 3):
        self._lock = threading.Lock()
        self._states: Dict[int, str] = {}        # worker_id → state
        self._hosts: Dict[int, str] = {}         # worker_id → hostname
        self._host_failures: Dict[str, int] = {}
        self._soft_failures: Dict[str, int] = {}  # straggler reports
        self._blacklist_threshold = blacklist_threshold

    def record_ready(self, worker_id: int, hostname: str):
        with self._lock:
            self._states[worker_id] = READY
            self._hosts[worker_id] = hostname

    def record_result(self, worker_id: int, state: str,
                      hostname: Optional[str] = None):
        with self._lock:
            self._states[worker_id] = state
            host = hostname or self._hosts.get(worker_id)
            if state == FAILURE and host is not None:
                self._host_failures[host] = \
                    self._host_failures.get(host, 0) + 1

    def record_soft_failure(self, hostname: str):
        """Count a SOFT failure against ``hostname``: the host is alive
        but chronically degraded (straggler score past
        HOROVOD_TAIL_BLACKLIST_SCORE).  Feeds the same per-host failure
        count as a crash, so repeat offenders reach the blacklist
        threshold and rotate out BEFORE they fail outright."""
        with self._lock:
            self._host_failures[hostname] = \
                self._host_failures.get(hostname, 0) + 1
            self._soft_failures[hostname] = \
                self._soft_failures.get(hostname, 0) + 1

    def soft_failure_count(self, hostname: str) -> int:
        with self._lock:
            return self._soft_failures.get(hostname, 0)

    @property
    def blacklist_threshold(self) -> int:
        return self._blacklist_threshold

    def state(self, worker_id: int) -> Optional[str]:
        with self._lock:
            return self._states.get(worker_id)

    def failure_count(self, hostname: str) -> int:
        with self._lock:
            return self._host_failures.get(hostname, 0)

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            return (self._host_failures.get(hostname, 0)
                    >= self._blacklist_threshold)

    def blacklisted_hosts(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(h for h, n in self._host_failures.items()
                         if n >= self._blacklist_threshold)
