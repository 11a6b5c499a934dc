"""``hvdrun-torch`` CLI (reference: ``horovodrun``, horovod/runner/launch.py
§3.4).

Counterpart: ``horovod_tpu/runner/launch.py``, whose flags this keeps:
``-np``, ``-H``/``--hostfile``, ``-p``/``--port``, ``--output-filename``,
``--verbose``, ``--start-timeout``, ``--network-interface``, and the
elastic flags (``--min-np``/``--max-np``/``--host-discovery-script``),
which hand off to the elastic driver.  The rendezvous is rank 0's
``torch.distributed.TCPStore`` on the first host at ``--port``; the job
needs no launcher-hosted store.  ``--check-build`` reports what the port
builds: its CUDA libraries and whether ``nvcc`` is there.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from . import spawn
from .hosts import assign_slots, effective_hosts

DEFAULT_PORT = 29410


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch a horovod_tpu_torch job across hosts/slots "
                    "(horovodrun for the PyTorch/CUDA port).")
    p.add_argument("-np", "--num-proc", dest="np", type=int, default=None,
                   help="total number of worker processes")
    p.add_argument("-H", "--hosts", dest="hosts", default=None,
                   help="comma-separated host:slots list, e.g. a:4,b:4")
    p.add_argument("--hostfile", default=None,
                   help="hostfile with 'hostname slots=N' lines")
    p.add_argument("-p", "--port", type=int, default=DEFAULT_PORT,
                   help="rank 0's store port on the first host")
    p.add_argument("--output-filename", default=None,
                   help="redirect each worker's output to FILE.<rank>")
    p.add_argument("--no-prefix-output", action="store_true",
                   help="do not prefix worker output with [rank]<host>")
    p.add_argument("--start-timeout", type=float, default=600.0,
                   help="seconds to wait for the job to finish rendezvous")
    p.add_argument("--network-interface", default=None,
                   help="local interface whose address remote workers "
                        "dial for the rendezvous (reference: horovodrun "
                        "--network-interface; default: "
                        "HOROVOD_NETWORK_INTERFACE env, else the route "
                        "toward the first remote host)")
    p.add_argument("--verbose", "-v", action="store_true")
    # elastic (reference: --min-np/--max-np/--host-discovery-script)
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None,
                   help="executable printing current 'host:slots' lines; "
                        "enables elastic mode")
    p.add_argument("--check-build", action="store_true",
                   help="print framework/feature availability and exit "
                        "(reference: horovodrun --check-build)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command, e.g. python train.py")
    args = p.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.check_build:
        return args
    if not args.command:
        p.error("no command given")
    if args.np is None and not args.host_discovery_script:
        p.error("-np is required (or use --host-discovery-script)")
    return args


def check_build(out=None) -> int:
    """Print the feature matrix (reference: ``horovodrun --check-build``
    lists built frameworks/controllers/ops): report only, nothing is
    compiled."""
    out = out or sys.stdout
    import importlib.util

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch
    from ..ops import _build

    def nvcc_found():
        try:
            return bool(_build.nvcc())
        except RuntimeError:
            return False

    built = {p.name.split("-", 1)[0].removeprefix("lib")
             for p in _build.BUILD_DIR.glob("lib*.so")}
    checks = [
        ("PyTorch", True),
        ("CUDA device visible", torch.cuda.is_available()),
        ("NCCL", dist.is_nccl_available()),
        ("Gloo", dist.is_gloo_available()),
        ("nvcc (builds csrc/*.cu at first use)", nvcc_found()),
    ]
    checks += [(f"CUDA library {name} built", name in built)
               for name in sorted(p.stem for p in _build.CSRC.glob("*.cu"))]
    checks.append(("Elastic training", importlib.util.find_spec(
        "horovod_tpu_torch.elastic") is not None))
    print(f"horovod_tpu_torch v{horovod_tpu_torch.__version__}:", file=out)
    print("\nAvailable features:", file=out)
    for name, ok in checks:
        print(f"    [{'X' if ok else ' '}] {name}", file=out)
    return 0


def _coordinator_addr(hosts, interface: Optional[str] = None) -> str:
    from .network import coordinator_addr
    return coordinator_addr([h.hostname for h in hosts], spawn.is_local,
                            interface=interface)


def run_launcher(args: argparse.Namespace) -> int:
    if args.check_build:
        return check_build()
    if args.host_discovery_script:
        from ..elastic.driver import run_elastic_launcher
        return run_elastic_launcher(args)
    hosts = effective_hosts(args.hosts, args.hostfile, args.np)
    slots = assign_slots(hosts, args.np)
    addr = _coordinator_addr(hosts, args.network_interface)
    if args.verbose:
        for s in slots:
            print(f"hvdrun-torch: rank {s.rank} -> {s.hostname} "
                  f"(local {s.local_rank}/{s.local_size})", file=sys.stderr)
        print(f"hvdrun-torch: rendezvous {addr}:{args.port}",
              file=sys.stderr)
    procs = spawn.spawn_workers(
        slots, args.command, addr, args.port,
        prefix_output=not args.no_prefix_output,
        output_filename=args.output_filename, base_env=dict(os.environ))
    return spawn.wait_workers(procs, timeout=args.start_timeout)


def main(argv: Optional[List[str]] = None) -> int:
    return run_launcher(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
