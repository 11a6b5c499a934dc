"""Tiny JSON-over-HTTP RPC used by the elastic driver and workers.

Reference parity: ``horovod/runner/http/http_server.py`` (the launcher's
HTTP KV rendezvous store) and ``horovod/runner/common/service/*`` (driver/
task services over sockets).  One mechanism covers both here: a threaded
HTTP server dispatching POSTed JSON bodies to named handlers.

Requests are HMAC-signed with the per-job secret (``secret.py``, parity
with upstream's request signing in ``runner/common/service``): when a
secret is configured — always, under the launcher/elastic driver — the
server rejects unsigned or tampered POSTs with 403 before dispatch.

Failure semantics (docs/elastic.md): ``json_request`` retries transient
transport failures (connection refused/reset, timeouts, 5xx) with
jittered exponential backoff; permanent failures (403/404) surface
immediately.  Non-idempotent calls pass ``idempotent=False`` and carry a
per-call idempotency token the server dedupes, so a retry whose first
attempt *did* reach the handler cannot double-apply (e.g. a FAILURE
report double-counting toward the host blacklist).  Both paths carry
chaos injection points (``rpc.request`` / ``rpc.server``) so fault
schedules can drop/delay/duplicate/5xx any control-plane message
deterministically (docs/env.md "Chaos engineering").

Counterpart: ``horovod_tpu/runner/rpc.py``, copied: it imports no jax,
and the port keeps its own copy because importing any module of the JAX
package imports jax.
"""

from __future__ import annotations

import http.client
import io
import json
import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .. import chaos as _chaos
from .. import metrics as _metrics
from . import secret as _secret

logger = logging.getLogger("horovod_tpu_torch")

# -- metric families (docs/metrics.md; sites guard on _metrics.ACTIVE) --------
_m_client_reqs = _metrics.counter(
    "hvd_rpc_client_requests_total",
    "RPC client calls by method and outcome", labels=("method", "outcome"))
_m_client_retries = _metrics.counter(
    "hvd_rpc_client_retries_total",
    "RPC client retry attempts after transient failures",
    labels=("method",))
_m_client_backoff = _metrics.counter(
    "hvd_rpc_client_backoff_seconds_total",
    "Total seconds the RPC client slept in retry backoff",
    labels=("method",))
_m_client_latency = _metrics.histogram(
    "hvd_rpc_request_duration_seconds",
    "RPC client request latency (successful attempt)",
    labels=("method",), lo=-17, hi=6)
_m_server_reqs = _metrics.counter(
    "hvd_rpc_server_requests_total",
    "RPC server POSTs dispatched by method and status",
    labels=("method", "status"))
_m_server_replays = _metrics.counter(
    "hvd_rpc_server_idem_replays_total",
    "Duplicate deliveries answered from the idempotency-token cache")
_m_conn_reuse = _metrics.counter(
    "hvd_rpc_conn_reuse_total",
    "Keep-alive connection pool outcomes per request: hit = reused an "
    "idle socket, miss = dialed fresh, stale = a reused socket had died "
    "and was redialed", labels=("result",))

_ENV = object()  # sentinel: resolve the secret from the environment

# Retry defaults (docs/env.md).  Read per call so tests and operators can
# adjust without reimporting; an env read is one dict lookup.
RETRIES_ENV = "HOROVOD_RPC_RETRIES"
BACKOFF_ENV = "HOROVOD_RPC_BACKOFF_S"
MAX_BACKOFF_ENV = "HOROVOD_RPC_MAX_BACKOFF_S"
KEEPALIVE_ENV = "HOROVOD_RPC_KEEPALIVE"

#: Idempotency-token replies remembered per server (LRU).
_IDEM_CACHE_SIZE = 4096

_jitter = random.Random()


def _default_retries() -> int:
    try:
        return int(os.environ.get(RETRIES_ENV, "3"))
    except ValueError:
        return 3


def _default_backoff() -> float:
    try:
        return float(os.environ.get(BACKOFF_ENV, "0.1"))
    except ValueError:
        return 0.1


def _default_max_backoff() -> float:
    try:
        return float(os.environ.get(MAX_BACKOFF_ENV, "2.0"))
    except ValueError:
        return 2.0


def jittered_backoff_s(attempt: int, base: float, cap: float,
                       rng: random.Random = _jitter) -> float:
    """Exponential backoff delay for retry ``attempt`` (0-based):
    ``base * 2**attempt`` capped at ``cap``, scaled by a uniform 0.5–1.5
    jitter.  Shared by the RPC client and the controller's KV retry so
    the backoff shape is defined once."""
    return min(cap, base * (2 ** attempt)) * (0.5 + rng.random())


def keepalive_enabled() -> bool:
    """``HOROVOD_RPC_KEEPALIVE`` (default on).  ``0`` restores the
    one-connection-per-request ``urlopen`` transport."""
    return os.environ.get(KEEPALIVE_ENV, "1") != "0"


class ConnectionPool:
    """Thread-safe idle-connection stacks keyed by ``(host, port)``.

    A connection is checked out by exactly one thread at a time (it is
    popped under the lock and only returned after the response body has
    been fully read), so no HTTP pipelining or socket sharing ever
    happens.  Bounded per endpoint: surplus connections returned to a
    full stack are closed instead of pooled, so a burst of concurrent
    callers cannot grow the pool without bound.
    """

    def __init__(self, max_idle_per_host: int = 4):
        self._lock = threading.Lock()
        self._idle: Dict[tuple, list] = {}
        self._max_idle = max_idle_per_host

    def get(self, host: str, port: int):
        """An idle connection for the endpoint, or None (dial fresh)."""
        with self._lock:
            stack = self._idle.get((host, port))
            return stack.pop() if stack else None

    def put(self, host: str, port: int, conn) -> None:
        with self._lock:
            stack = self._idle.setdefault((host, port), [])
            if len(stack) < self._max_idle:
                stack.append(conn)
                return
        conn.close()  # pool full: close outside the lock

    def clear(self) -> None:
        """Close every idle connection (tests / interpreter teardown)."""
        with self._lock:
            conns = [c for stack in self._idle.values() for c in stack]
            self._idle.clear()
        for c in conns:
            c.close()


_POOL = ConnectionPool()


def _post_pooled(addr: str, port: int, name: str, body: bytes,
                 headers: dict, timeout: float) -> dict:
    """One POST over a pooled keep-alive connection.

    Stale-socket detection: a server restart or idle-timeout close only
    surfaces when the next request hits the dead socket, so a
    CONNECTION-level failure on a REUSED connection is retried once on a
    freshly dialed one (counted ``stale``).  A TIMEOUT is not staleness —
    the server is slow, not gone, and the request may still be executing
    (a parked ``key_value_dir_watch`` in particular), so an eager resend
    would double the caller's wait and burn a second held-watch slot; it
    propagates to ``json_request``'s retry/backoff machinery instead,
    like any failure on a freshly dialed connection.
    """
    went_stale = False
    for reused in (True, False):
        conn = _POOL.get(addr, port) if reused else None
        if reused and conn is None:
            continue  # nothing idle: fall through to the fresh dial
        if conn is None:
            conn = http.client.HTTPConnection(addr, port, timeout=timeout)
        try:
            if conn.sock is not None:  # pooled: refresh the deadline
                conn.sock.settimeout(timeout)
            conn.request("POST", f"/{name}", body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except Exception as e:
            conn.close()
            if reused and not isinstance(e, TimeoutError):
                went_stale = True
                if _metrics.ACTIVE:
                    _m_conn_reuse.inc(result="stale")
                continue  # the socket had died under us: redial once
            raise
        if _metrics.ACTIVE and not went_stale:
            # exactly ONE outcome per request: a stale-then-redialed
            # request already counted as "stale"
            _m_conn_reuse.inc(result="hit" if reused else "miss")
        if resp.will_close:
            conn.close()
        else:
            _POOL.put(addr, port, conn)
        if resp.status >= 400:
            raise urllib.error.HTTPError(
                f"http://{addr}:{port}/{name}", resp.status, resp.reason,
                resp.headers, io.BytesIO(data))
        return json.loads(data or b"{}")
    raise http.client.HTTPException(
        "keep-alive pool exhausted")  # pragma: no cover - loop covers both


class JsonRpcServer:
    """HTTP server mapping POST /<name> with a JSON body to
    ``handlers[name](payload) -> response dict``.

    ``secret`` defaults to the job secret from ``HOROVOD_SECRET_KEY``;
    pass ``None`` explicitly to run unauthenticated (unit tests only).

    Requests carrying an ``_idem`` token (sent by ``json_request(...,
    idempotent=False)``) are deduplicated: a token seen before returns
    the cached reply without re-invoking the handler, so client retries
    of non-idempotent methods are safe.

    GET routes: every server also answers ``GET /metrics`` (Prometheus
    text exposition of the process registry) and ``GET /healthz``
    (JSON liveness) — read-only introspection, served unauthenticated
    because scrapers cannot HMAC-sign (POST dispatch stays signed).
    ``get_routes`` adds/overrides routes; a route is a zero-arg callable
    returning ``(status, content_type, body)``.
    """

    def __init__(self, handlers: Dict[str, Callable],
                 port: int = 0, host: str = "0.0.0.0",
                 secret=_ENV,
                 get_routes: Optional[Dict[str, Callable]] = None):
        self._handlers = dict(handlers)
        self._get_routes = dict(_metrics.get_routes())
        if get_routes:
            self._get_routes.update(get_routes)
        self._secret = (_secret.get_secret_key()
                        if secret is _ENV else secret)
        self._idem: "OrderedDict[str, bytes]" = OrderedDict()
        self._idem_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: HTTP/1.1 persistent connections, so the client
            # pool can reuse one socket across control-plane calls.
            # Every reply path sends Content-Length (send_error included),
            # which 1.1 requires for the connection to stay open.
            protocol_version = "HTTP/1.1"
            # a reply is two small writes (header flush + body); Nagle
            # would hold the second behind the first's ACK, putting a
            # delayed-ack stall on the control plane's wake path
            disable_nagle_algorithm = True

            def _reply(self, body: bytes):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                name = self.path.split("?", 1)[0].strip("/")
                route = outer._get_routes.get(name)
                if route is None:
                    self.send_error(404, f"no GET route: {name}")
                    return
                try:
                    status, ctype, body = route()
                except Exception as e:  # noqa: BLE001 - report to caller
                    logger.exception("GET route %s failed", name)
                    self.send_error(500, str(e))
                    return
                data = (body if isinstance(body, bytes)
                        else body.encode("utf-8"))
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                name = self.path.strip("/")
                fn = outer._handlers.get(name)
                if fn is None:
                    self.send_error(404, f"no handler: {name}")
                    return
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) or b"{}"
                if outer._secret is not None and not _secret.verify(
                        outer._secret, name, raw,
                        self.headers.get(_secret.SIGNATURE_HEADER),
                        self.headers.get(_secret.TIMESTAMP_HEADER)):
                    logger.warning(
                        "rejected unauthenticated rpc POST /%s", name)
                    self.send_error(
                        403, "missing or invalid request signature")
                    return
                drop_reply = False
                if _chaos.ACTIVE:
                    try:
                        act = _chaos.fire("rpc.server", method=name)
                    except Exception as e:  # noqa: BLE001 - injected 5xx
                        self.send_error(500, f"chaos: {e}")
                        return
                    if act is not None and act.kind == "drop":
                        # lost REQUEST: the handler never runs; the
                        # client sees the connection close with no
                        # status line and retries
                        self.close_connection = True
                        return
                    if act is not None and act.kind == "drop-reply":
                        # lost REPLY: the handler DOES run (and its
                        # reply is cached for an idempotency token), the
                        # connection then closes unanswered — the
                        # faithful simulation of a retry whose first
                        # attempt was applied
                        drop_reply = True
                marker = None
                try:
                    payload = json.loads(raw)
                    idem = (payload.pop("_idem", None)
                            if isinstance(payload, dict) else None)
                    if idem is not None:
                        # claim-or-replay under the lock: a duplicate
                        # arriving while the first delivery's handler is
                        # still running must WAIT for its reply, not
                        # dispatch the handler a second time
                        entry = None
                        with outer._idem_lock:
                            entry = outer._idem.get(idem)
                            if entry is None:
                                marker = threading.Event()
                                outer._idem[idem] = marker
                        if isinstance(entry, bytes):
                            if _metrics.ACTIVE:
                                _m_server_replays.inc()
                                _m_server_reqs.inc(method=name,
                                                   status="replay")
                            self._reply(entry)
                            return
                        if entry is not None:      # in flight elsewhere
                            entry.wait(70.0)
                            with outer._idem_lock:
                                done = outer._idem.get(idem)
                            if isinstance(done, bytes):
                                if _metrics.ACTIVE:
                                    _m_server_replays.inc()
                                    _m_server_reqs.inc(method=name,
                                                       status="replay")
                                self._reply(done)
                            else:
                                # first delivery failed or is wedged:
                                # tell the client to retry later rather
                                # than double-dispatching
                                self.send_error(
                                    503, "duplicate of an in-flight "
                                         "or failed request; retry")
                            return
                    resp = fn(payload) or {}
                    body = json.dumps(resp).encode()
                    if idem is not None:
                        with outer._idem_lock:
                            outer._idem[idem] = body
                            outer._idem.move_to_end(idem)
                            while len(outer._idem) > _IDEM_CACHE_SIZE:
                                outer._idem.popitem(last=False)
                        marker.set()
                        marker = None
                except Exception as e:  # noqa: BLE001 - report to caller
                    logger.exception("rpc handler %s failed", name)
                    if _metrics.ACTIVE:
                        _m_server_reqs.inc(method=name, status="error")
                    if _metrics.RECORDING:
                        _metrics.event("rpc.handler_failed", method=name,
                                       error=str(e))
                    self.send_error(500, str(e))
                    return
                finally:
                    if marker is not None:   # handler failed: release
                        with outer._idem_lock:
                            if outer._idem.get(idem) is marker:
                                del outer._idem[idem]
                        marker.set()
                if _metrics.ACTIVE:
                    _m_server_reqs.inc(method=name, status="ok")
                if drop_reply:
                    self.close_connection = True
                    return
                self._reply(body)

            def log_message(self, *args):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def add_handlers(self, handlers: Dict[str, Callable]) -> None:
        """Register additional POST handlers on a live server (the
        elastic driver attaches the serving plane's
        ``serve_submit``/``serve_pull``/``serve_push`` data path to its
        already-running control server).  Publication is one dict
        rebind: an in-flight dispatch sees the old table or the new
        one, never a torn state."""
        self._handlers = {**self._handlers, **handlers}

    def add_get_routes(self, routes: Dict[str, Callable]) -> None:
        """Same post-construction registration for GET routes."""
        self._get_routes = {**self._get_routes, **routes}

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _post_once(addr: str, port: int, name: str, body: bytes,
               secret, timeout: float) -> dict:
    headers = {"Content-Type": "application/json"}
    if secret is not None:
        # re-signed per attempt: retries get a fresh timestamp, so a
        # long backoff chain cannot drift past the freshness window
        headers.update(_secret.sign_headers(secret, name, body))
    if keepalive_enabled():
        return _post_pooled(addr, port, name, body, headers, timeout)
    req = urllib.request.Request(
        f"http://{addr}:{port}/{name}", data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def json_request(addr: str, port: int, name: str,
                 payload: Optional[dict] = None,
                 timeout: float = 30.0, secret=_ENV,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 max_backoff: Optional[float] = None,
                 idempotent: bool = True) -> dict:
    """POST ``payload`` to http://addr:port/<name>; returns the JSON reply.

    The body is HMAC-signed with the job secret when one is configured
    (``HOROVOD_SECRET_KEY``); ``secret=None`` sends unsigned.

    Transient transport failures (connection refused/reset, timeouts,
    HTTP 5xx) are retried up to ``retries`` times (default
    ``HOROVOD_RPC_RETRIES``, 3) with jittered exponential backoff
    (``backoff * 2**attempt``, capped at ``max_backoff``, scaled by a
    uniform 0.5–1.5 jitter).  ``retries=0`` opts out for callers with
    their own poll loop.  Permanent failures (4xx: bad signature,
    unknown endpoint) raise immediately.

    ``idempotent=False`` attaches a per-call idempotency token that
    every retry reuses and the server dedupes — required for methods
    whose double-delivery is not a no-op (failure reports feeding the
    blacklist).  Token dedup also defuses chaos-injected duplicate
    sends (``action=dup``).
    """
    if secret is _ENV:
        secret = _secret.get_secret_key()
    if retries is None:
        retries = _default_retries()
    if backoff is None:
        backoff = _default_backoff()
    if max_backoff is None:
        max_backoff = _default_max_backoff()
    data = dict(payload or {})
    if not idempotent:
        data["_idem"] = uuid.uuid4().hex
    body = json.dumps(data).encode()

    last_exc: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            act = None
            if _chaos.ACTIVE:
                act = _chaos.fire("rpc.request", method=name, addr=addr,
                                  port=port, attempt=attempt)
            t0 = time.monotonic()
            reply = _post_once(addr, port, name, body, secret, timeout)
            if act is not None and act.kind == "dup":
                # duplicate delivery: the reply that "counts" is the
                # second — idempotency tokens make both land identically
                reply = _post_once(addr, port, name, body, secret,
                                   timeout)
            if _metrics.ACTIVE:
                _m_client_latency.observe(time.monotonic() - t0,
                                          method=name)
                _m_client_reqs.inc(method=name, outcome="ok")
            return reply
        except urllib.error.HTTPError as e:
            if e.code < 500:
                if _metrics.ACTIVE:
                    _m_client_reqs.inc(method=name, outcome="permanent")
                raise  # permanent: auth/unknown-endpoint; retry is futile
            last_exc = e
        except (urllib.error.URLError, OSError,
                http.client.HTTPException,
                _chaos.ChaosError) as e:
            # ChaosError: an injected generic fault at this site is
            # transient by definition — the retry path must absorb it
            # like the transport faults it stands in for
            last_exc = e
        if attempt >= retries:
            if _metrics.ACTIVE:
                _m_client_reqs.inc(method=name, outcome="exhausted")
            if _metrics.RECORDING:
                _metrics.event("rpc.failed", method=name, addr=addr,
                               port=port, attempts=attempt + 1,
                               error=str(last_exc))
            raise last_exc
        delay = jittered_backoff_s(attempt, backoff, max_backoff)
        if _metrics.ACTIVE:
            _m_client_retries.inc(method=name)
            _m_client_backoff.inc(delay, method=name)
        if _metrics.RECORDING:
            _metrics.event("rpc.retry", method=name, addr=addr,
                           port=port, attempt=attempt + 1,
                           error=str(last_exc))
        logger.debug("rpc %s to %s:%d failed (%s); retry %d/%d in %.2fs",
                     name, addr, port, last_exc, attempt + 1, retries,
                     delay)
        time.sleep(delay)
    raise last_exc  # pragma: no cover - loop always returns or raises
