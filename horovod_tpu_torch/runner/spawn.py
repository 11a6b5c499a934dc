"""Worker spawning: command construction + process supervision.

Counterpart: ``horovod_tpu/runner/spawn.py``.  The env contract is the
same but for the rendezvous: ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``
name rank 0's ``torch.distributed.TCPStore`` (which ``runtime.init``
reads), and ``HOROVOD_CONTROLLER`` is left as the base environment sets it
(the JAX package pins ``jax``).  Remote hosts get the ``HOROVOD_*``,
``TORCH_*``, ``NCCL_*`` and ``CUDA_*`` variables.  There is no
launcher-hosted KV store: rank 0's store is the job's.

Reference parity: ``horovod/runner/gloo_run.py`` (per-slot worker exec
with the env contract pointing at the rendezvous) and ``mpi_run.py``
(remote command construction — we assert the *generated command line* in
tests the same way ``test/single/test_run.py`` does).  Remote hosts are reached over
ssh like the reference's bootstrap; localhost workers are plain
subprocesses.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

from . import secret as _secret
from .hosts import SlotAssignment

LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}

SSH_OPTS = ["-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes"]


def is_local(hostname: str) -> bool:
    import socket
    return (hostname in LOCAL_NAMES
            or hostname == socket.gethostname()
            or hostname == socket.getfqdn())


def ensure_job_secret(base_env: Optional[Dict[str, str]] = None) -> str:
    """The job's control-plane secret, minting one on first launch.

    Looks in ``base_env`` then ``os.environ``; a freshly minted key is
    published to ``os.environ`` so launcher-side RPC (and later spawns)
    sign with the same key the workers receive.
    """
    key = ((base_env or {}).get(_secret.SECRET_ENV)
           or os.environ.get(_secret.SECRET_ENV))
    if not key:
        key = _secret.make_secret_key()
    os.environ[_secret.SECRET_ENV] = key
    return key


def worker_env(slot: SlotAssignment, coordinator_addr: str,
               coordinator_port: int,
               base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The full §3.4 environment contract for one worker."""
    env = dict(base_env if base_env is not None else os.environ)
    env.update(slot.to_env())
    env.update({
        # rank 0 hosts the job's TCPStore at this address and port
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": coordinator_addr,
        "HOROVOD_GLOO_RENDEZVOUS_PORT": str(coordinator_port),
        "HOROVOD_NUM_PROCESSES": str(slot.size),
        "HOROVOD_PROCESS_ID": str(slot.rank),
    })
    return env


def remote_command(slot: SlotAssignment, command: Sequence[str],
                   env: Dict[str, str], cwd: str) -> List[str]:
    """Build the ssh command line for a remote worker (reference: mpi_run /
    gloo_run remote exec).  Only HOROVOD_*/TORCH_/NCCL_/CUDA_ vars are
    forwarded — the reference forwards an explicit allowlist via ``-x``
    for the same reason (remote shells own the rest of their
    environment)."""
    forwarded = {k: v for k, v in env.items()
                 if k.startswith(("HOROVOD_", "TORCH_", "NCCL_", "CUDA_",
                                  "PYTHONPATH"))}
    # the job secret must NOT ride the ssh argv (visible in ps/procfs on
    # both hosts); it is delivered on the remote shell's stdin instead —
    # see the `read` prefix below and the stdin write in spawn_workers
    has_secret = forwarded.pop(_secret.SECRET_ENV, None) is not None
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in sorted(forwarded.items()))
    remote = f"cd {shlex.quote(cwd)} && env {exports} " + " ".join(
        shlex.quote(c) for c in command)
    if has_secret:
        remote = (f"IFS= read -r {_secret.SECRET_ENV} && "
                  f"export {_secret.SECRET_ENV} && " + remote)
    return ["ssh", *SSH_OPTS, slot.hostname, remote]


class WorkerProcess:
    def __init__(self, slot: SlotAssignment, popen: subprocess.Popen):
        self.slot = slot
        self.popen = popen
        self.pump: Optional[threading.Thread] = None


def _pump_output(proc: WorkerProcess, prefix: bool, out_file=None):
    stream = proc.popen.stdout
    tag = f"[{proc.slot.rank}]<{proc.slot.hostname}>"
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace")
        if out_file is not None:
            out_file.write(line)
            out_file.flush()
        else:
            sys.stdout.write(f"{tag}: {line}" if prefix else line)
            sys.stdout.flush()


def spawn_workers(slots: List[SlotAssignment], command: Sequence[str],
                  coordinator_addr: str, coordinator_port: int,
                  prefix_output: bool = True,
                  output_filename: Optional[str] = None,
                  base_env: Optional[Dict[str, str]] = None
                  ) -> List[WorkerProcess]:
    procs: List[WorkerProcess] = []
    cwd = os.getcwd()
    # one control-plane secret per job (upstream mints in the launcher and
    # distributes via the env): published launcher-side too so this
    # process's RPC signs with the same key the workers verify against
    secret_key = ensure_job_secret(base_env)
    for slot in slots:
        env = worker_env(slot, coordinator_addr, coordinator_port, base_env)
        env.setdefault(_secret.SECRET_ENV, secret_key)
        if is_local(slot.hostname):
            cmd, popen_env, stdin_data = list(command), env, None
        else:
            cmd, popen_env = remote_command(slot, command, env, cwd), None
            # secret via stdin, never argv (see remote_command)
            stdin_data = (env[_secret.SECRET_ENV] + "\n").encode()
        popen = subprocess.Popen(
            cmd, env=popen_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            stdin=subprocess.PIPE if stdin_data else subprocess.DEVNULL,
            start_new_session=True)
        if stdin_data:
            try:
                popen.stdin.write(stdin_data)
                popen.stdin.flush()
            except OSError:
                pass  # worker died at exec; the reaper reports it
            popen.stdin.close()
        proc = WorkerProcess(slot, popen)
        out_file = (open(f"{output_filename}.{slot.rank}", "w")
                    if output_filename else None)
        proc.pump = threading.Thread(
            target=_pump_output, args=(proc, prefix_output, out_file),
            daemon=True)
        proc.pump.start()
        procs.append(proc)
    return procs


def wait_workers(procs: List[WorkerProcess],
                 timeout: Optional[float] = None) -> int:
    """Wait for all workers; on first failure terminate the rest.

    Returns the exit code to propagate (0 iff every worker exited 0) —
    the reference's gloo_run semantics.
    """
    exit_code = 0
    pending = list(procs)
    try:
        while pending:
            for p in list(pending):
                try:
                    rc = p.popen.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                pending.remove(p)
                if rc != 0 and exit_code == 0:
                    exit_code = rc
                    sys.stderr.write(
                        f"hvdrun-torch: worker rank {p.slot.rank} "
                        f"({p.slot.hostname}) exited with {rc}; "
                        f"terminating remaining workers\n")
                    for q in pending:
                        _terminate(q)
    except KeyboardInterrupt:
        for q in pending:
            _terminate(q)
        exit_code = 128 + signal.SIGINT
    for p in procs:
        if p.pump is not None:
            p.pump.join(timeout=2)
    return exit_code


def _terminate(p: WorkerProcess, grace: float = 5.0):
    if p.popen.poll() is not None:
        return
    try:
        os.killpg(p.popen.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    try:
        p.popen.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.popen.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
