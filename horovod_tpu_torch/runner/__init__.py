"""Process launcher and control-plane transport (counterpart:
``horovod_tpu/runner/``, reference: horovod/runner/ — ``horovodrun``).

``python -m horovod_tpu_torch.runner -np N cmd ...`` (console script
``hvdrun-torch``) spawns one worker process per slot across hosts,
exports the reference's §3.4 environment contract
(HOROVOD_RANK/SIZE/LOCAL_RANK/..., and the rendezvous address and port of
rank 0's ``TCPStore``), and streams rank-prefixed output;
``--host-discovery-script`` starts the elastic driver instead
(``elastic/driver.py``).  ``rpc.py`` and ``secret.py`` are the
HMAC-signed JSON RPC the elastic driver and the serving plane speak.
``runner/api.py``'s ``hvd.run`` and ``runner/executor.py`` are not ported
yet (ROADMAP.md A8).
"""

from .launch import main, parse_args  # noqa: F401
