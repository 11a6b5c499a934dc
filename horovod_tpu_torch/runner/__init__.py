"""The control plane's transport: HMAC-signed JSON-over-HTTP RPC.

Counterpart: ``horovod_tpu/runner/``, of which the port has the jax-free
transport so far: ``rpc.py`` (``JsonRpcServer``, ``json_request``, the
keep-alive ``ConnectionPool``) and ``secret.py`` (the per-job HMAC key).
The launcher (``hvdrun``) is not ported yet (ROADMAP.md A9).
"""
