"""The quantized wire formats of the port against the JAX package's.

``compression.py``: the format table, ``quantize_blocks`` and
``dequantize_blocks`` on the same numpy inputs in both packages, held bit
for bit (payload bytes, scale bits, dequantized bits) against JAX's
functions compiled by ``jax.jit``, as every JAX collective runs them (XLA
turns the scale's ``amax / qmax`` into a multiply by the reciprocal, which
an eager call does not), for int8, fp8 e4m3
and fp8 e5m2, on fp32 and bf16 inputs over many decades, with subnormals,
saturating values, round-half-to-even ties, all-zero blocks and ragged
(zero-padded) buffers.

``ops/collectives.py``: the quantized sum with error feedback, the
average, and the sum-scatter, run by 2 and 4 real rank processes over
gloo (tests/torch_ranks.py ``case_wire``), against the JAX package's
``quantized_allreduce_p`` and ``quantized_sum_scatter_p`` under ``pmap``
on as many virtual CPU devices, per rank.  Tolerance: the payloads and scales
agree bit for bit (the quantizer test); XLA fuses the dequantizing
multiply into the following add or subtract where PyTorch rounds the
product first; the port fuses them too (``compression.fma``), and the
residuals are held within four fp32 roundings of their
block's absmax, the scattered tile within 1e-6 relative, and the sum and
average, which requantize that tile, within that plus one quantization
step (``_close``).  The same launch runs an eager
allreduce through the engine under ``HOROVOD_COMPRESSION=int8`` with
``HOROVOD_COMPRESSION_DCN_ONLY=0``, which must equal the quantized
staging without feedback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import compression as jc
from horovod_tpu.ops.collectives import (quantized_allreduce_p,
                                         quantized_sum_scatter_p)
from horovod_tpu_torch import compression as tc

import torch_ranks as tr

AXIS = "qw"
WORLDS = (2, 4)
WIRE_ENV = {"HOROVOD_COMPRESSION": "int8",
            "HOROVOD_COMPRESSION_DCN_ONLY": "0",
            "HOROVOD_COMPRESSION_BLOCK_SIZE": str(tr.ZBLOCK)}


def _inputs(block):
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(300).astype(np.float32)
        * (10.0 ** rng.uniform(-8, 6, 300)).astype(np.float32),
        np.zeros(2 * block, np.float32),                     # zero blocks
        rng.randn(44).astype(np.float32) * np.float32(1e-30),
        np.array([448.0, -57344.0, 1e38, -1e-45, 0.5, 1.5, 2.5, -2.5],
                 np.float32)])
    pad = (-len(x)) % block           # ragged: padded as callers pad
    return np.concatenate([x, np.zeros(pad, np.float32)])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else
                  np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("name", tc.WIRE_FORMATS)
@pytest.mark.parametrize("block", [16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_blocks_bit_exact_against_jax(name, block, dtype):
    jf = jc.resolve_wire_format(name, block)
    tf = tc.resolve_wire_format(name, block)
    x = _inputs(block)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jax.jit(lambda v: jc.quantize_blocks(v, jf))(jx)
    tq, ts = tc.quantize_blocks(tx, tf)
    assert tq.dtype == tf.wire_dtype and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), _bits(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(tc.dequantize_blocks(tq, ts, tf).numpy()),
        _bits(jax.jit(lambda q, sc: jc.dequantize_blocks(q, sc, jf))(jq, js)))
    # all-zero blocks: scale 1, exact round trip
    zero = slice(-(-300 // block) * block, -(-300 // block) * block + block)
    assert (ts.numpy()[zero.start // block] == 1.0)


def test_format_table_matches_jax():
    assert tc.WIRE_FORMATS == jc.WIRE_FORMATS
    for name in tc.WIRE_FORMATS:
        j, t = jc.resolve_wire_format(name), tc.resolve_wire_format(name)
        assert (t.name, t.block_size, t.qmax) == (j.name, j.block_size,
                                                  j.qmax)
        assert str(t.wire_dtype).removeprefix("torch.") == \
            jnp.dtype(j.wire_dtype).name
        for numel in (1, 255, 256, 1000):
            assert t.wire_nbytes(numel) == j.wire_nbytes(numel)
        assert tc.resolve_wire_format(t, 64).block_size == 64
    for spec in (None, "", "none"):
        assert tc.resolve_wire_format(spec) is None
    with pytest.raises(ValueError, match="unknown wire format"):
        tc.resolve_wire_format("int4")
    with pytest.raises(ValueError, match="positive"):
        tc.resolve_wire_format("int8", 0)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert tc.quantizable(dt) and jc.quantizable(
            str(dt).removeprefix("torch."))
    for dt in (torch.float64, torch.int32, torch.int8):
        assert not tc.quantizable(dt)


def test_scale_and_code_of_a_reciprocal_tie_match_compiled_jax():
    """The first input where the port parted from the JAX package at
    world 4 on the int8 wire: a block whose scale ``amax / 127`` and
    ``amax * (1 / 127)`` differ in the last place, with an element that
    lands on a half step under one and just below it under the other.
    XLA compiles the division into the multiply, so the code is 2 (1.5
    rounded to even), where an fp32 division gives 1."""
    jf = jc.resolve_wire_format("int8", 16)
    tf = tc.resolve_wire_format("int8", 16)
    x = np.zeros(16, np.float32)
    x[0], x[1] = np.float32(0.30671477), np.float32(0.0036226152)
    assert np.round(x[1] / (x[0] / np.float32(127))) == 1
    jq, js = jax.jit(lambda v: jc.quantize_blocks(v, jf))(jnp.asarray(x))
    tq, ts = tc.quantize_blocks(torch.from_numpy(x), tf)
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tq[1]) == 2


def test_dequantize_accumulate_rounds_once_as_compiled_jax():
    """Four ranks' codes for one tile, summed as JAX's compiled
    ``quantized_sum_scatter_p`` sums them (each dequantizing multiply
    fused into the add), and the error-feedback residual as its fused
    subtract: bit for bit, where rounding each product first does not."""
    n, block = 4, 16
    jf = jc.resolve_wire_format("int8", block)
    tf = tc.resolve_wire_format("int8", block)
    flats = np.random.RandomState(3).randn(n, n * block * 8).astype(
        np.float32)
    tile, res = jax.pmap(
        lambda x: quantized_sum_scatter_p(x, AXIS, jf, error_feedback=True),
        axis_name=AXIS, devices=jax.devices()[:n])(jnp.asarray(flats))
    m = flats.shape[1] // n
    coded = [tc.quantize_blocks(torch.from_numpy(f), tf) for f in flats]
    rounded_first = False
    for r in range(n):
        qx = torch.cat([q[r * m:(r + 1) * m] for q, _ in coded])
        sx = torch.cat([s[r * m // block:(r + 1) * m // block]
                        for _, s in coded])
        got = tc.dequantize_sum(qx, sx, tf, n)
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(np.asarray(tile[r])))
        plain = tc.dequantize_blocks(qx, sx, tf).reshape(n, -1).sum(0)
        rounded_first |= not torch.equal(plain, got)
        q, s = coded[r]
        np.testing.assert_array_equal(
            _bits(tc.quantization_error(torch.from_numpy(flats[r]), q, s,
                                        tf).numpy()),
            _bits(np.asarray(res[r])))
    assert rounded_first


def test_bf16_compressor_round_trips():
    x = torch.randn(8)
    wire, ctx = tc.Compression.bf16.compress(x)
    assert wire.dtype == torch.bfloat16 and ctx == torch.float32
    assert tc.Compression.bf16.decompress(wire, ctx).dtype == torch.float32
    i = torch.arange(4)
    assert tc.Compression.bf16.compress(i) == (i, None)


class _Worlds(dict):
    def __init__(self, tmp_path_factory):
        super().__init__()
        self._tmp = tmp_path_factory

    def __missing__(self, world):
        self[world] = tr.launch(world, ["wire"],
                                self._tmp.mktemp(f"wire{world}"),
                                env=WIRE_ENV)
        return self[world]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def jax_wire(n, name):
    """Per-rank results of the JAX staging on ``n`` virtual devices."""
    fmt = jc.resolve_wire_format(name, tr.ZBLOCK)
    x = np.stack([tr.wire_input(r) for r in range(n)])
    r0 = np.stack([tr.wire_residual(r) for r in range(n)])
    pad = (-x.shape[1]) % (n * tr.ZBLOCK)

    def f(v, r):
        s, res = quantized_allreduce_p(v, AXIS, fmt, op=jhvd.Sum,
                                       residual=r, error_feedback=True)
        avg, _ = quantized_allreduce_p(v, AXIS, fmt, op=jhvd.Average)
        flat = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
        tile, tres = quantized_sum_scatter_p(flat, AXIS, fmt,
                                             error_feedback=True)
        plain, _ = quantized_allreduce_p(v, AXIS, fmt, op=jhvd.Sum)
        return s, res, avg, tile, tres, plain

    outs = jax.pmap(f, axis_name=AXIS, devices=jax.devices()[:n])(x, r0)
    keys = ("sum", "res", "avg", "tile", "tile_res", "plain")
    return [{k: np.asarray(o[r]) for k, o in zip(keys, outs)}
            for r in range(n)]


def _quantum(want, name):
    """One step of the gather stage's quantization at each element of a
    result: the block scale (absmax / qmax of the gathered tile's block)
    times the spacing of the wire dtype at the scaled value."""
    fmt = jc.resolve_wire_format(name, tr.ZBLOCK)
    n = len(want)
    blocks = np.pad(want, (0, (-n) % tr.ZBLOCK)).reshape(-1, tr.ZBLOCK)
    scale = np.abs(blocks).max(1, keepdims=True) / fmt.qmax
    scale = np.where(scale > 0, scale, 1.0)
    v = np.abs(blocks) / scale
    if name == "int8":
        step = np.ones_like(v)
    else:
        mant = {"fp8_e4m3": 3, "fp8_e5m2": 2}[name]
        e = np.floor(np.log2(np.maximum(v, 2.0 ** -6)))
        step = 2.0 ** (e - mant)
    return (step * scale).reshape(-1)[:n]


def _block_amax(x):
    n = len(x)
    blocks = np.pad(np.abs(x), (0, (-n) % tr.ZBLOCK)).reshape(-1, tr.ZBLOCK)
    return np.repeat(blocks.max(1), tr.ZBLOCK)[:n]


def _close(got, want, name, what, contrib=None):
    """XLA fuses the dequantizing multiply into the next add or subtract
    (where PyTorch rounds the product first) and may reorder that
    arithmetic, so: a residual ``contrib - q·s`` is held within four fp32
    roundings of its block's absmax (2^-21 of it, against a quantization
    step of at least absmax/127); the tile, an
    fp32 sum of the same dequantized payloads, within 1e-6 relative; the
    sum and average, which requantize that tile for the gather, may also
    land one quantization step away where the tile sits on a rounding
    boundary."""
    if what in ("res", "tile_res"):
        tol = 2.0 ** -21 * _block_amax(contrib)
    else:
        tol = 1e-6 * np.abs(want)
        if what != "tile":
            tol = tol + _quantum(want, name)
    assert (np.abs(got - want) <= tol).all(), (what, got, want)


@pytest.mark.parametrize("name", tc.WIRE_FORMATS)
@pytest.mark.parametrize("world", WORLDS)
def test_quantized_collectives_match_jax_per_rank(ranks, world, name):
    want = jax_wire(world, name)
    for r, res in enumerate(ranks[world]):
        got = res["wire"][name]
        x = tr.wire_input(r)
        contrib = {"res": x + tr.wire_residual(r),
                   "tile_res": np.pad(x, (0, len(want[r]["tile_res"])
                                          - len(x)))}
        for what in ("sum", "res", "avg", "tile", "tile_res"):
            assert got[what].shape == want[r][what].shape, what
            _close(got[what], want[r][what], name, what,
                   contrib.get(what))


@pytest.mark.parametrize("world", WORLDS)
def test_eager_allreduce_takes_the_quantized_wire(ranks, world):
    """HOROVOD_COMPRESSION=int8 with HOROVOD_COMPRESSION_DCN_ONLY=0: the
    engine quantizes a float allreduce bucket without feedback (the JAX
    engine's rule on a flat mesh), so every rank gets the staging's sum."""
    want = jax_wire(world, "int8")
    exact = np.stack([tr.wire_input(r) for r in range(world)])
    for r, res in enumerate(ranks[world]):
        _close(res["wire"]["eager"], want[r]["plain"], "int8", "eager")
        # and it is not the full-width sum
        assert not np.array_equal(res["wire"]["eager"], exact.sum(0))
        np.testing.assert_allclose(res["wire"]["eager_avg"],
                                   exact.mean(0), rtol=0.05,
                                   atol=np.abs(exact).max() / 64)
        assert res["stats"]["buckets"] > 0
