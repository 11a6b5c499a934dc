"""Parity of the port's ResNet, MNIST and classifier step with the JAX
package's.

Weights come from the JAX package's ``init`` and cross as numpy through
``horovod_tpu_torch.convert`` (HWIO convolutions as OIHW); images are
made from a numpy seed, NHWC for JAX and NCHW for the port.  Forward
(logits and the new batch-norm state), eval on the running statistics and
3 steps of the classifier step are compared.  The ``"SAME"`` padding of a
strided window is asymmetric at even sizes (0 before and 1 after a 3x3/2
window, 2 and 3 for the 7x7/2 stem), so the image sizes are 32 (every
strided window asymmetric), 33 (every one symmetric) and 35 (a symmetric
stem, then an asymmetric max-pool at 18); a symmetric ``padding=`` fails
at 32 and 35 (``test_symmetric_padding_would_not_match``).  Over 2 and 4
gloo rank processes the step with synchronized batch norm equals one
process on the global batch, and without it the ranks average their
batch-norm state.

Tolerances, fp32 on both sides: the same arithmetic in another order.
Logits and state of the forward within rtol 1e-4 / atol 5e-5: convolutions
sum up to 4608 products through 18-50 layers, and at 32x32 ResNet-50's
last stage is 1x1, so its batch norm takes 4 values a channel, where
E[x^2] - E[x]^2 in fp32 loses digits (there each side lies up to ~2e-5
from an fp64 run of the port; at batch 2 ~3e-4, so batch 4); the 3-step
trajectories
within atol 2e-5 (the JAX package's own dp-8 against dp-1 test), losses
rtol 1e-5.  bf16 MNIST logits within 2e-2 of their largest entry (bf16
rounding at places that differ between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_ranks as tr
from horovod_tpu import training as jtraining
from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from horovod_tpu.parallel.mesh import ParallelMesh as JParallelMesh
from horovod_tpu_torch import convert, training
from horovod_tpu_torch.models import mnist, resnet
from horovod_tpu_torch.tree import tree_leaves, tree_paths

WORLDS = (2, 4)
FWD = dict(rtol=1e-4, atol=5e-5)


def _jcfg(variant):
    return jresnet.ResNetConfig(variant=variant, num_classes=10, width=8,
                                dtype=jnp.float32)


def _tcfg(variant):
    return resnet.ResNetConfig(variant=variant, num_classes=10, width=8,
                               dtype=torch.float32)


def _jax_init(variant, seed=0):
    params, state = jresnet.init(_jcfg(variant), jax.random.PRNGKey(seed))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def _images(B, size, seed=1):
    """NCHW float32 images."""
    return np.random.RandomState(seed).randn(B, 3, size, size).astype(
        np.float32)


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def _assert_tree_close(jax_tree, port_tree, **tol):
    """A JAX-layout numpy tree against the port's tree (converted back)."""
    got = dict(zip(tree_paths(port_tree), tree_leaves(port_tree)))
    for path, want in jax.tree_util.tree_leaves_with_path(jax_tree):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        np.testing.assert_allclose(got[key], np.asarray(want), err_msg=key,
                                   **tol)


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (7, 2)])
def test_same_pads_are_xla_s(k, stride):
    for size in range(1, 40):
        want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
        assert resnet.same_pads(size, k, stride) == tuple(want), size


@pytest.mark.parametrize("variant", [18, 50])
@pytest.mark.parametrize("size", [32, 33, 35])
def test_forward_matches_jax(variant, size):
    """Train mode: logits and the new state; then eval on that state."""
    jp, js = _jax_init(variant)
    x = _images(4, size)
    jlogits, jstate = jresnet.forward(jp, js, jnp.asarray(_nhwc(x)),
                                      _jcfg(variant))
    jeval, _ = jresnet.forward(jp, jstate, jnp.asarray(_nhwc(x)),
                               _jcfg(variant), train=False)
    tp, ts = convert.resnet_params_from_numpy(jp, js, device="cpu")
    with torch.no_grad():
        logits, state = resnet.forward(tp, ts, torch.from_numpy(x),
                                       _tcfg(variant))
        evl, same = resnet.forward(tp, state, torch.from_numpy(x),
                                   _tcfg(variant), train=False)
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FWD)
    _assert_tree_close(jax.tree_util.tree_map(np.asarray, jstate),
                       convert.resnet_params_to_numpy(tp, state)[1], **FWD)
    np.testing.assert_allclose(evl.numpy(), np.asarray(jeval), **FWD)
    for a, b in zip(tree_leaves(same), tree_leaves(state)):
        assert a is b    # eval leaves the running statistics as they were


@pytest.mark.parametrize("size", [32, 35])
def test_symmetric_padding_would_not_match(monkeypatch, size):
    """The sizes above test the padding: with torch's symmetric
    ``padding=k//2`` in place of XLA's pads the logits move by far more
    than the forward's tolerance."""
    jp, js = _jax_init(18)
    x = _images(2, size)
    jlogits, _ = jresnet.forward(jp, js, jnp.asarray(_nhwc(x)), _jcfg(18))
    monkeypatch.setattr(resnet, "conv_same", lambda x, w, stride=1: F.conv2d(
        x, w.to(x.dtype), stride=stride, padding=w.shape[2] // 2))
    monkeypatch.setattr(resnet, "max_pool_same", lambda x, k=3, stride=2:
                        F.max_pool2d(x, k, stride, padding=k // 2))
    tp, ts = convert.resnet_params_from_numpy(jp, js, device="cpu")
    with torch.no_grad():
        logits, _ = resnet.forward(tp, ts, torch.from_numpy(x), _tcfg(18))
    diff = np.abs(logits.numpy() - np.asarray(jlogits)).max()
    assert diff > 100 * (FWD["atol"] + FWD["rtol"] * np.abs(
        np.asarray(jlogits)).max()), diff


def test_resnet50_param_count_and_convert_round_trip():
    """ResNet-50 at 1000 classes: the canonical ~25.5M parameters, the
    JAX package's count exactly, and its leaves' shapes after convert."""
    cfg = resnet.ResNetConfig(variant=50, num_classes=1000)
    params, state = resnet.init(cfg, seed=0, device="cpu")
    n = resnet.num_params(params)
    assert abs(n - 25_557_032) < 30_000, n
    jshapes = jax.eval_shape(lambda: jresnet.init(
        jresnet.ResNetConfig(variant=50, num_classes=1000),
        jax.random.PRNGKey(0)))
    assert n == jresnet.num_params(jshapes[0])
    back = convert.resnet_params_to_numpy(params, state)
    for jt, pt in zip(jshapes, back):
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): leaf.shape for path, leaf in
                jax.tree_util.tree_leaves_with_path(jt)}
        got = dict(zip(tree_paths(pt), (a.shape for a in tree_leaves(pt))))
        assert got == want
    # zero-initialized last batch-norm scale of every block
    assert all(not blk["bn2"]["scale"].any() for i in range(4)
               for blk in params[f"stage{i}"])
    jp, js = _jax_init(18)
    tp, ts = convert.resnet_params_from_numpy(jp, js, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                    jax.tree_util.tree_leaves(
                        convert.resnet_params_to_numpy(tp, ts))):
        np.testing.assert_array_equal(a, b)


def _jax_classifier_run(forward, init, batches, optimizer=None):
    pmesh = JParallelMesh(JMeshConfig(dp=1), devices=jax.devices()[:1])
    kw = {} if optimizer is None else {"optimizer": optimizer}
    ts = jtraining.make_classifier_train_step(forward, init, pmesh, **kw)
    params, state, opt_state = ts.init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree_util.tree_map(np.array, (params, state))
    losses, accs = [], []
    for x, y in batches:
        params, state, opt_state, loss, acc = ts.step_fn(
            params, state, opt_state, jnp.asarray(_nhwc(x)), jnp.asarray(
                y.astype(np.int32)))
        losses.append(float(loss))
        accs.append(float(acc))
    return init_np, losses, accs, jax.tree_util.tree_map(
        np.asarray, (params, state))


def test_classifier_step_matches_jax():
    """3 steps of the ResNet-18 classifier step at dp 1 with the default
    optimizer (``optax.sgd(0.1, momentum=0.9)`` / torch's SGD)."""
    jcfg, tcfg = _jcfg(18), _tcfg(18)
    batches = [tr.classifier_batch(s) for s in range(3)]
    (jp, js), losses, accs, (jp3, js3) = _jax_classifier_run(
        lambda p, s, x, train, axis_name: jresnet.forward(
            p, s, x, jcfg, train=train, axis_name=axis_name),
        lambda rng: jresnet.init(jcfg, rng), batches)
    ts = training.make_classifier_train_step(
        lambda p, s, x, train, process_set: resnet.forward(
            p, s, x, tcfg, train=train, process_set=process_set),
        lambda seed: resnet.init(tcfg, seed, device="cpu"), device="cpu")
    params, state = convert.resnet_params_from_numpy(jp, js, device="cpu")
    opt_state = ts.opt_init(params)
    got_l, got_a = [], []
    for x, y in batches:
        params, state, opt_state, loss, acc = ts.step_fn(
            params, state, opt_state, torch.from_numpy(x),
            torch.from_numpy(y))
        got_l.append(loss.item())
        got_a.append(acc.item())
    np.testing.assert_allclose(got_l, losses, rtol=1e-5)
    assert got_a == accs
    p3, s3 = convert.resnet_params_to_numpy(params, state)
    _assert_tree_close(jp3, p3, rtol=0, atol=2e-5)
    _assert_tree_close(js3, s3, rtol=0, atol=2e-5)
    logits = ts.eval_fn(params, state, torch.from_numpy(batches[0][0]))
    assert logits.shape == (tr.CLS_BATCH, 10) and not logits.requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mnist_forward_matches_jax(dtype):
    jcfg = jmnist.MnistConfig(dtype=getattr(jnp, dtype))
    tcfg = mnist.MnistConfig(dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(np.asarray, jmnist.init(
        jcfg, jax.random.PRNGKey(0)))
    x = np.random.RandomState(2).rand(4, 1, 28, 28).astype(np.float32)
    want = np.asarray(jmnist.forward(jp, jnp.asarray(_nhwc(x)), jcfg))
    tp = convert.mnist_params_from_numpy(jp, device="cpu")
    got = mnist.forward(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())
    back = convert.mnist_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_mnist_step_matches_jax():
    """3 classifier steps of MNIST (stateless) at dp 1 with the default
    optimizer.  (Adam would divide gradients near 0 by their own root
    mean square, which turns their rounding into differences up to lr.)"""
    jcfg = jmnist.MnistConfig(dtype=jnp.float32)
    tcfg = mnist.MnistConfig(dtype=torch.float32)
    rng = np.random.RandomState(3)
    batches = [(rng.rand(8, 1, 28, 28).astype(np.float32),
                rng.randint(0, 10, 8).astype(np.int64)) for _ in range(3)]
    (jp, _), losses, accs, (jp3, _) = _jax_classifier_run(
        lambda p, s, x, train, axis_name: (jmnist.forward(p, x, jcfg), s),
        lambda rng: (jmnist.init(jcfg, rng), {}), batches)
    ts = training.make_classifier_train_step(
        lambda p, s, x, train, process_set: (mnist.forward(p, x, tcfg), s),
        lambda seed: (mnist.init(tcfg, seed, device="cpu"), {}),
        device="cpu")
    params, state = convert.mnist_params_from_numpy(jp, device="cpu"), {}
    opt_state = ts.opt_init(params)
    got = []
    for x, y in batches:
        params, state, opt_state, loss, acc = ts.step_fn(
            params, state, opt_state, torch.from_numpy(x),
            torch.from_numpy(y))
        got.append(loss.item())
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    _assert_tree_close(jp3, convert.mnist_params_to_numpy(params), rtol=0,
                       atol=2e-5)


# -- over rank processes ------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.Worlds(tmp_path_factory, ["classifier"])


def _flat(tree):
    return {p: t.detach().numpy() for p, t in zip(tree_paths(tree),
                                                  tree_leaves(tree))}


@pytest.mark.parametrize("world", WORLDS)
def test_sync_bn_step_over_ranks_equals_one_process(ranks, world):
    """dp = world with synchronized batch norm: losses, accuracies,
    weights and running statistics after 2 steps as one process on the
    global batch; every rank the same."""
    ts = tr.resnet_step("cpu", sync_bn=True)
    params, state, opt_state = ts.init_fn(0)
    losses, accs = [], []
    for step in range(tr.CLS_STEPS):
        x, y = tr.classifier_batch(step)
        params, state, opt_state, loss, acc = ts.step_fn(
            params, state, opt_state, torch.from_numpy(x),
            torch.from_numpy(y))
        losses.append(loss.item())
        accs.append(acc.item())
    want = {"params": _flat(params), "state": _flat(state)}
    for r in ranks[world]:
        got = r["classifier"]["sync_bn=True"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["accuracy"], accs, rtol=1e-6)
        for tree in ("params", "state"):
            for path, a in want[tree].items():
                np.testing.assert_allclose(got[tree][path], a, rtol=0,
                                           atol=2e-5, err_msg=path)


@pytest.mark.parametrize("world", WORLDS)
def test_local_bn_step_averages_the_state(ranks, world):
    """sync_bn=False: each rank normalizes over its own rows, and the
    new running statistics are the mean of the ranks' (one process
    normalizing each rank's rows alone, the states averaged)."""
    ts = tr.resnet_step("cpu", sync_bn=False)
    params, state, _ = ts.init_fn(0)
    x, _ = tr.classifier_batch(0)
    k = tr.CLS_BATCH // world
    with torch.no_grad():
        states = [_flat(resnet.forward(params, state, torch.from_numpy(
            x[r * k:(r + 1) * k]), tr.resnet_cfg())[1]) for r in range(world)]
    for r in ranks[world]:
        got = r["classifier"]["sync_bn=False"]["state"]
        for path in states[0]:
            np.testing.assert_allclose(
                got[path], np.mean([s[path] for s in states], 0), rtol=0,
                atol=1e-6, err_msg=path)
    first = ranks[world][0]["classifier"]["sync_bn=False"]
    for r in ranks[world][1:]:
        for tree in ("params", "state"):
            for path, a in first[tree].items():
                np.testing.assert_array_equal(
                    r["classifier"]["sync_bn=False"][tree][path], a)
