"""Distributed optimizer wrappers (counterpart: ``horovod_tpu/optim/``;
reference: horovod/torch/optimizer.py)."""

from .distributed import (  # noqa: F401
    DistributedOptimizer, DistributedGradientTransform, fused_reduce_tree,
    fused_reduce_scatter_tree, all_gather_sharded_tree, shard_tree_like,
    broadcast_parameters, broadcast_optimizer_state, recovery_payload,
    restore_dist_state, state_partition_specs, SpecPlan, make_spec_plan,
    sharded_tile_layout,
)
from .precision import adamw_lp, tree_nbytes  # noqa: F401
