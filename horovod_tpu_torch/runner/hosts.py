"""Host / slot parsing and rank assignment.

Counterpart: ``horovod_tpu/runner/hosts.py``, copied (it imports no jax;
the port keeps its own copy because importing any module of the JAX
package imports jax).  Reference parity: ``horovod/runner/launch.py``
``parse_host_files`` / ``parse_hosts`` and
``horovod/runner/common/util/hosts.py`` — hosts are given as ``-H
host1:slots,host2:slots`` or a ``--hostfile`` with ``hostname slots=N``
lines; ranks are assigned host-major (all of host 0's
slots, then host 1's, ...), which fixes HOROVOD_LOCAL_RANK and
HOROVOD_CROSS_RANK exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(spec: str) -> "HostInfo":
        spec = spec.strip()
        if ":" in spec:
            host, slots = spec.rsplit(":", 1)
            return HostInfo(host, int(slots))
        return HostInfo(spec, 1)


def parse_hosts(hosts_arg: str) -> List[HostInfo]:
    """Parse ``-H a:2,b:2`` host list."""
    out = [HostInfo.from_string(h) for h in hosts_arg.split(",") if h.strip()]
    if not out:
        raise ValueError(f"no hosts in {hosts_arg!r}")
    return out


def parse_hostfile(path: str) -> List[HostInfo]:
    """Parse a hostfile of ``hostname slots=N`` (or ``hostname N``) lines."""
    out: List[HostInfo] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            if len(parts) > 1:
                p = parts[1]
                slots = int(p.split("=", 1)[1]) if p.startswith("slots=") \
                    else int(p)
            out.append(HostInfo(parts[0], slots))
    if not out:
        raise ValueError(f"no hosts found in hostfile {path}")
    return out


@dataclasses.dataclass(frozen=True)
class SlotAssignment:
    """One worker process's identity (the §3.4 env contract values)."""
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int   # index of this worker's host
    cross_size: int   # number of hosts
    hostname: str

    def to_env(self) -> Dict[str, str]:
        return {
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
            "HOROVOD_HOSTNAME": self.hostname,
        }


def assign_slots(hosts: List[HostInfo], np_: int) -> List[SlotAssignment]:
    """Host-major rank assignment over available slots (reference order)."""
    total = sum(h.slots for h in hosts)
    if np_ > total:
        raise ValueError(
            f"requested -np {np_} exceeds {total} available slots on "
            f"{len(hosts)} hosts")
    used: List[HostInfo] = []
    remaining = np_
    for h in hosts:
        if remaining <= 0:
            break
        take = min(h.slots, remaining)
        used.append(HostInfo(h.hostname, take))
        remaining -= take
    out: List[SlotAssignment] = []
    rank = 0
    for cross_rank, h in enumerate(used):
        for local_rank in range(h.slots):
            out.append(SlotAssignment(
                rank=rank, size=np_, local_rank=local_rank,
                local_size=h.slots, cross_rank=cross_rank,
                cross_size=len(used), hostname=h.hostname))
            rank += 1
    return out


def effective_hosts(hosts_arg: Optional[str], hostfile: Optional[str],
                    np_: int) -> List[HostInfo]:
    if hosts_arg and hostfile:
        raise ValueError("use either -H or --hostfile, not both")
    if hosts_arg:
        return parse_hosts(hosts_arg)
    if hostfile:
        return parse_hostfile(hostfile)
    return [HostInfo("localhost", np_)]
