"""Process launcher and control-plane transport (counterpart:
``horovod_tpu/runner/``, reference: horovod/runner/ — ``horovodrun``).

``python -m horovod_tpu_torch.runner -np N cmd ...`` (console script
``hvdrun-torch``) spawns one worker process per slot across hosts,
exports the reference's §3.4 environment contract
(HOROVOD_RANK/SIZE/LOCAL_RANK/..., and the rendezvous address and port of
rank 0's ``TCPStore``), and streams rank-prefixed output;
``--host-discovery-script`` starts the elastic driver instead
(``elastic/driver.py``).  :func:`run` (``hvd.run``) launches a pickled
function on ``np`` workers and returns their results by rank;
:class:`TpuExecutor` keeps a pool of initialized workers for repeated
calls.  ``rpc.py`` and ``secret.py`` are the HMAC-signed JSON RPC the
elastic driver, the serving plane and the recovery plane speak.
"""

from .api import run  # noqa: F401
from .executor import TpuExecutor  # noqa: F401
from .launch import main, parse_args  # noqa: F401
