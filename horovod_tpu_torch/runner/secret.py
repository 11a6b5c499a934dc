"""Per-job shared secret for authenticating the control-plane RPC.

Reference parity: ``horovod/runner/common/util/secret.py`` (the launcher
mints one random key per job and every runner/elastic service message is
HMAC-signed with it; unsigned or tampered messages are dropped).  Here the
key travels in the spawn environment as ``HOROVOD_SECRET_KEY`` (hex), each
JSON-RPC request body is signed with HMAC-SHA256, and ``JsonRpcServer``
verifies the signature before dispatching — a stray or malicious POST to
an elastic driver/worker endpoint is rejected with 403 instead of failing
the job or forcing a spurious re-form.

The signature binds the endpoint name and a timestamp along with the body,
so a captured request neither verifies against a different endpoint nor
replays outside the freshness window (``HOROVOD_RPC_TS_TOLERANCE`` seconds,
default 900 — generous for clock skew across hosts).

Counterpart: ``horovod_tpu/runner/secret.py``, copied: it imports no
jax, and the port keeps its own copy because importing any module of the
JAX package imports jax.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import secrets as _secrets
import time
from typing import Optional

SECRET_ENV = "HOROVOD_SECRET_KEY"
SIGNATURE_HEADER = "X-Horovod-Signature"
TIMESTAMP_HEADER = "X-Horovod-Timestamp"
TS_TOLERANCE_ENV = "HOROVOD_RPC_TS_TOLERANCE"


def make_secret_key() -> str:
    """Mint a fresh per-job key (hex, 256 bits)."""
    return _secrets.token_hex(32)


def get_secret_key() -> Optional[bytes]:
    """The job's secret from the environment, or None if not configured."""
    key = os.environ.get(SECRET_ENV)
    if not key:
        return None
    return key.encode()


def ts_tolerance() -> float:
    try:
        return float(os.environ.get(TS_TOLERANCE_ENV, "900"))
    except ValueError:
        return 900.0


def sign(secret: bytes, name: str, timestamp: str, body: bytes) -> str:
    msg = name.encode() + b"\n" + timestamp.encode() + b"\n" + body
    return hmac.new(secret, msg, hashlib.sha256).hexdigest()


def sign_headers(secret: bytes, name: str, body: bytes) -> dict:
    """Signature + timestamp headers for one outgoing request."""
    ts = str(int(time.time()))
    return {SIGNATURE_HEADER: sign(secret, name, ts, body),
            TIMESTAMP_HEADER: ts}


def verify(secret: bytes, name: str, body: bytes,
           signature: Optional[str], timestamp: Optional[str]) -> bool:
    if not signature or not timestamp:
        return False
    try:
        skew = abs(time.time() - int(timestamp))
    except ValueError:
        return False
    if skew > ts_tolerance():
        return False
    return hmac.compare_digest(sign(secret, name, timestamp, body),
                               signature)
