"""Routable-address / network-interface selection for the launcher.

Counterpart: ``horovod_tpu/runner/network.py``, copied (it imports no
jax).  Reference parity: ``horovod/runner/util/network.py`` +
``horovodrun --network-interface[s]`` (SURVEY.md §3.4 NIC matching) —
the reference resolves which local interface every host should use for
the rendezvous service instead of trusting ``gethostname()`` to be
routable.  Multi-NIC GPU hosts have the same problem: the hostname can
resolve to a management address that workers on the data network cannot
reach.

Selection order (:func:`coordinator_addr`):

1. an explicit interface (``--network-interface`` /
   ``HOROVOD_NETWORK_INTERFACE``) → that interface's IPv4;
2. all workers local → ``gethostname()`` (loopback routing is fine);
3. otherwise → the source address the kernel routes toward the first
   REMOTE host (a connected UDP socket performs the route lookup; no
   packet is sent), falling back to ``gethostname()`` when the lookup
   fails (e.g. the host resolves only at the workers).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Sequence

ENV_INTERFACE = "HOROVOD_NETWORK_INTERFACE"


def list_interfaces() -> Dict[str, str]:
    """Name → IPv4 for every interface with an address (linux ioctl;
    interfaces without an IPv4 address are omitted)."""
    import fcntl
    import struct
    out: Dict[str, str] = {}
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _idx, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", name.encode()[:15]))
                out[name] = socket.inet_ntoa(packed[20:24])
            except OSError:
                continue  # interface has no IPv4 address
    return out


def resolve_interface(name: str) -> str:
    """IPv4 of ``name``, or ValueError listing the usable interfaces."""
    ifaces = list_interfaces()
    try:
        return ifaces[name]
    except KeyError:
        raise ValueError(
            f"network interface {name!r} not found or has no IPv4 "
            f"address; available: {sorted(ifaces)}") from None


def routable_source_addr(remote_host: str, port: int = 1) -> Optional[str]:
    """The local source IP the kernel would route toward ``remote_host``
    (connected-UDP route lookup — nothing is transmitted), or None when
    the host does not resolve/route from here."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((remote_host, port))
            return s.getsockname()[0]
    except OSError:
        return None


def coordinator_addr(hostnames: Sequence[str], is_local,
                     interface: Optional[str] = None) -> str:
    """The address workers should dial for the coordination service.

    The service lives in rank 0's process — on ``hostnames[0]``.  When
    that host is REMOTE, its hostfile name is returned unchanged (the
    user asserted it is reachable by naming it).  When it is THIS
    machine, the selection order from the module docstring picks which
    of the driver's addresses remote workers should dial.

    ``is_local`` is a predicate (``spawn.is_local``); ``interface``
    overrides detection (falls back to the ``HOROVOD_NETWORK_INTERFACE``
    env contract).
    """
    first = hostnames[0]
    if not is_local(first):
        return first
    interface = interface or os.environ.get(ENV_INTERFACE)
    if interface:
        return resolve_interface(interface)
    remotes = [h for h in hostnames if not is_local(h)]
    if not remotes:
        return socket.gethostname()
    src = routable_source_addr(remotes[0])
    return src if src is not None else socket.gethostname()


def local_service_addr(worker_host: str, is_local,
                       interface: Optional[str] = None) -> str:
    """The address a worker on ``worker_host`` should dial to reach a
    service running on THIS machine (elastic driver RPC, notification
    endpoints) — same selection order as :func:`coordinator_addr` with
    the service pinned here."""
    interface = interface or os.environ.get(ENV_INTERFACE)
    if interface:
        return resolve_interface(interface)
    if is_local(worker_host):
        return socket.gethostname()
    src = routable_source_addr(worker_host)
    return src if src is not None else socket.gethostname()
