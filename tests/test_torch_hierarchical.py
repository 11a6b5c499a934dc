"""The port's hierarchical allreduce and allgather against the JAX
package's.

Four real rank processes over gloo (``tests/torch_ranks.py`` ``case_hier``)
form two hosts of two (``HOROVOD_LOCAL_SIZE=2``, ``HOROVOD_CROSS_SIZE=2``)
with ``HOROVOD_HIERARCHICAL_ALLREDUCE`` and ``_ALLGATHER`` on; the JAX side
runs ``hierarchical_allreduce_p`` under ``shard_map`` on a (2, 2) mesh of
virtual CPU devices.  Full width the results agree bit for bit on seeded
fp32: every stage sums two values, which is commutative, and the average
divides by 4 on both sides.  The int8 cross stage agrees within
``tests/test_torch_wire.py``'s bounds (``_close``: the requantized sum may
land one quantization step away).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import compression as jc
from horovod_tpu import config as jconfig
from horovod_tpu.ops.collectives import hierarchical_allreduce_p
import horovod_tpu_torch as hvd
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch import runtime as truntime

import torch_ranks as tr
from test_torch_wire import _close

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.launch(WORLD, ["hier"], tmp_path_factory.mktemp("hier"),
                     env=tr.HIER_ENV)


def jax_hier(xs, op, pre=None, post=None, wire=None):
    """Each rank's result of the JAX two-stage allreduce of the rows of
    ``xs`` on a (cross 2, local 2) mesh, ranks host-major."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                             ("cross", "local"))

    def f(x):
        v = x[0]
        if pre is not None:
            v = v * jnp.float32(pre)
        r = hierarchical_allreduce_p(v, "cross", "local", op=op,
                                     wire_format=wire)
        if post is not None:
            r = r * jnp.float32(post)
        return r[None]

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(("cross", "local")),
                              out_specs=P(("cross", "local")),
                              check_vma=False))
    return np.asarray(g(jnp.asarray(np.stack(xs))))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_hier_shape_and_groups_at_two_by_two(ranks):
    for r, res in enumerate(ranks):
        got = res["hier"]
        assert tuple(got["shape"]) == (2, 2)
        assert got["local"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["cross"] == [r % 2, r % 2 + 2]


@pytest.mark.parametrize("what,op,pre,post", [
    ("sum", jhvd.Sum, None, None),
    ("avg", jhvd.Average, None, None),
    ("scaled", jhvd.Average, 0.5, 4.0),
])
def test_hierarchical_allreduce_bit_for_bit(ranks, what, op, pre, post):
    """Sum, Average and a scaled Average of 37 seeded fp32 values (odd:
    the pad path) through the engine, bit for bit the JAX program's."""
    want = jax_hier([tr.hier_input(r) for r in range(WORLD)], op, pre,
                    post)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(_bits(res["hier"][what]),
                                      _bits(want[r]))


def test_hierarchical_fused_bucket_bit_for_bit(ranks):
    """A grouped allreduce of two tensors is one bucket: the hierarchical
    sum of their concatenation, split back."""
    want = jax_hier([tr.hier_input(r) for r in range(WORLD)], jhvd.Sum)
    for r, res in enumerate(ranks):
        got = res["hier"]
        np.testing.assert_array_equal(_bits(got["grp0"]),
                                      _bits(want[r][:12].reshape(3, 4)))
        np.testing.assert_array_equal(_bits(got["grp1"]),
                                      _bits(want[r][12:]))


def test_hierarchical_allgather_in_rank_order(ranks):
    """Equal sizes take the two-stage gather; uneven ones the flat one:
    both are every rank's rows in rank order."""
    want = np.concatenate([tr.hier_input(r, 6).reshape(3, 2)
                           for r in range(WORLD)])
    want_v = np.concatenate([tr.hier_input(r, 2 * (r + 1)).reshape(r + 1, 2)
                             for r in range(WORLD)])
    for res in ranks:
        np.testing.assert_array_equal(res["hier"]["ag"], want)
        np.testing.assert_array_equal(res["hier"]["agv"], want_v)


def test_forced_layout_through_the_test_hook(ranks):
    """``ProcessSet._hier_shape`` forces a layout: (4, 1) makes one cross
    group of every rank at first use, and the sum stays exact."""
    want = sum(tr.quarter_input(r) for r in range(WORLD))
    for res in ranks:
        np.testing.assert_array_equal(res["hier"]["forced"], want)
        assert res["hier"]["forced_cross"] == [0, 1, 2, 3]


def test_strict_rounds_counted_per_hierarchical_bucket(ranks):
    """Every hierarchical dispatch runs one strict tail round: the four
    allreduce buckets of the case (sum, avg, scaled, the group)."""
    for res in ranks:
        assert res["hier"]["strict_rounds"] == 4


def test_int8_cross_stage_within_the_wire_bounds(ranks):
    """HOROVOD_COMPRESSION=int8 under the DCN-only default quantizes the
    cross stage only: each rank's sum within test_torch_wire.py's bound of
    the JAX program's, the int8 wire bytes those of the cross chunk."""
    fmt = jc.resolve_wire_format("int8", tr.ZBLOCK)
    want = jax_hier([tr.hier_input(r, 64) for r in range(WORLD)], jhvd.Sum,
                    wire=fmt)
    exact = np.stack([tr.hier_input(r, 64) for r in range(WORLD)]).sum(0)
    for r, res in enumerate(ranks):
        got = res["hier"]["int8"]
        _close(got, want[r], "int8", "sum")
        assert not np.array_equal(got, exact)
        # 64 elements a rank, 32 a host chunk: int8 lanes plus fp32 scales
        assert res["hier"]["int8_wire_bytes"] == 32 + 4 * (32 // tr.ZBLOCK)


@pytest.mark.parametrize("ranks_,hosts,want", [
    ([0, 1, 2, 3], [0, 0, 1, 1], (2, 2)),
    ([0, 1, 2, 3, 4, 5], [0, 0, 0, 1, 1, 1], (2, 3)),
    ([0, 1, 2, 3], [0, 1, 2, 3], (4, 1)),
    ([0, 1, 2, 3], None, None),              # no host layout
    ([0, 1], [0, 0, 1, 1], None),             # one host
    ([0, 1, 2], [0, 0, 1, 1], None),          # hosts of unequal size
    ([0, 1, 2, 3], [0, 1, 0, 1], None),       # not host-major
    ([1, 3], [0, 0, 1, 1], (2, 1)),           # a subset: one a host
])
def test_hier_shape_detection(ranks_, hosts, want):
    assert truntime._detect_hier(ranks_, hosts) == want


def test_no_hierarchy_at_world_one():
    hvd.init(device="cpu")
    try:
        assert hvd.runtime._get_global_process_set().hier_shape() is None
        assert hvd.runtime._state().hosts is None
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("env,values", [
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", ["1", "true", "0", "no", ""]),
    ("HOROVOD_HIERARCHICAL_ALLGATHER", ["1", "on", "0", "off"]),
])
def test_hierarchical_knobs_parse_as_in_jax(monkeypatch, env, values):
    """The knobs no longer raise and parse as the JAX package's config."""
    import os
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    for v in values:
        monkeypatch.setenv(env, v)
        try:
            want = dataclasses.asdict(jconfig.Config.from_env())
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tconfig.Config.from_env()
            continue
        assert dataclasses.asdict(tconfig.Config.from_env()) == want, v
    assert env not in {u[0] for u in tconfig.UNPORTED}
