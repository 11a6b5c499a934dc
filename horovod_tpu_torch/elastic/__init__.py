"""Elastic training: fault-tolerant runs over dynamic worker membership.

Counterpart: ``horovod_tpu/elastic/``; reference parity:
``horovod/common/elastic.py`` + ``horovod/torch/elastic/`` +
``horovod/runner/elastic/`` (SURVEY.md §2.2/§3.5/§5.3).  Wrap the training
loop with ``@hvd.elastic.run``; commit state snapshots periodically
(:class:`TensorState` for the port's trees of tensors, :class:`TorchState`
for a module and its optimizer, :class:`ObjectState` for picklable
attributes); on a collective failure (a peer died) restore the last
commit and re-initialize; on a membership change (``HostsUpdatedInterrupt``
from the discovery driver, ``driver.py``) re-sync state from the new rank
0 and continue.  Checkpointless recovery (``HOROVOD_RECOVERY``,
``recovery.py``): a ``RecoveryAgent`` pushes each rank's ZeRO tiles to a
peer at the transform's boundaries (``DistributedGradientTransform(...,
recovery=agent)``), and a replacement rebuilds its own from the fleet
(``agent.rebuild()``, ``optim.restore_dist_state``); the driver holds the
``RecoveryDirectory``.
"""

from .discovery import (  # noqa: F401
    FixedHostDiscovery, HostDiscovery, HostDiscoveryScript,
    NotifiedPreemptionDiscovery,
)
from .runner import run  # noqa: F401
from .sampler import ElasticSampler  # noqa: F401
from .state import (  # noqa: F401
    ObjectState, State, TensorState, TorchState,
)
