"""The port's image models against the JAX package's, on the CPU.

The port's initial weights, perturbed (and BatchNorm statistics set away
from their 0/1 start, so every term is exercised), go to the flax model
through ``to_jax_params`` and back through ``from_jax_params``; the same
seeded NHWC batch goes through both models.

- ``TinyMLP`` and ``SimpleCNN``: logits and every parameter gradient.
- Narrow ResNets, a BasicBlock/cifar variant and a Bottleneck/imagenet
  variant, each on an even and an odd input size (the strided SAME convs
  pad asymmetrically on even sizes): train-mode logits, the updated
  ``batch_stats``, every gradient, and eval-mode logits (running stats).
- ``to_jax_params`` gives the tree of flax's own ``init`` (names and
  shapes) and ``from_jax_params`` inverts it exactly.
- The initialization's statistics follow flax's.

Tolerance: f32; convolutions, BatchNorm reductions and their backward sum
in different orders in XLA and PyTorch, which moves logits by ~1e-6 (seen:
at most 6e-7) and gradients by a few ulps of their scale: atol 2e-5 /
rtol 1e-4, as the transformer's parity tests use.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import resnet as jresnet
from distributeddataparallel_tpu.models import simple_cnn as jcnn
from distributeddataparallel_tpu.ops import cross_entropy_loss as j_ce
from distributeddataparallel_tpu_torch.models import resnet as tresnet
from distributeddataparallel_tpu_torch.models import simple_cnn as tcnn
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params
from distributeddataparallel_tpu_torch.models.layers import same_pads
from distributeddataparallel_tpu_torch.ops.losses import cross_entropy_loss
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

TOL = dict(atol=2e-5, rtol=1e-4)
CLASSES = 5


def _models(name, size):
    """(flax model, port model) of one test configuration."""
    if name == "mlp":
        return (jcnn.TinyMLP(features=(16, 8), num_classes=CLASSES),
                tcnn.TinyMLP((size, size, 3), (16, 8), CLASSES))
    if name == "cnn":
        return jcnn.SimpleCNN(num_classes=CLASSES, widths=(4, 8)), tcnn.SimpleCNN(CLASSES, (4, 8))
    stem, jblock, tblock = {
        "basic": ("cifar", jresnet.BasicBlock, tresnet.BasicBlock),
        "bottleneck": ("imagenet", jresnet.BottleneckBlock, tresnet.BottleneckBlock),
    }[name]
    kw = dict(stage_sizes=(1, 2), num_classes=CLASSES, num_filters=4, stem=stem)
    return jresnet.ResNet(block_cls=jblock, **kw), tresnet.ResNet(block_cls=tblock, **kw)


def _setup(name, size):
    jm, tm = _models(name, size)
    rng = np.random.default_rng(size)
    x = rng.normal(size=(6, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(6,)).astype(np.int32)
    v = to_jax_params(tm.state_dict(), tm)
    v["params"] = jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), v["params"])
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32), v["batch_stats"])
    tm.load_state_dict(from_jax_params(v, tm))
    return jm, tm, v, x, y


def _torch_grads(tm, x, y):
    tm.zero_grad()
    logits = tm(torch.from_numpy(x))
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    return logits.detach().numpy(), grads


def _close_tree(got, want, what):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_allclose(a, np.asarray(flat_want[path]), err_msg=f"{what} {path}", **TOL)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_tiny_models_logits_and_grads_match_jax(name):
    jm, tm, v, x, y = _setup(name, 9)

    def loss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x))
        return j_ce(logits, jnp.asarray(y)), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    logits, grads = _torch_grads(tm, x, y)
    np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL)
    _close_tree(to_jax_params(grads, tm)["params"], jgrads, "grad")


@pytest.mark.parametrize("name,size", [
    ("basic", 8), ("basic", 9), ("bottleneck", 16), ("bottleneck", 17)])
def test_resnet_train_stats_grads_and_eval_match_jax(name, size):
    jm, tm, v, x, y = _setup(name, size)

    def loss(params, stats):
        logits, new = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
        return j_ce(logits, jnp.asarray(y)), (logits, new["batch_stats"])

    @jax.jit
    def reference(params, stats):
        (_, (logits, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params, stats)
        evals = jm.apply({"params": params, "batch_stats": new_stats}, jnp.asarray(x), train=False)
        return logits, new_stats, grads, evals

    jlogits, jstats, jgrads, jeval = reference(v["params"], v["batch_stats"])
    tm.train()
    logits, grads = _torch_grads(tm, x, y)
    np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL)
    _close_tree(to_jax_params(grads | {k: b for k, b in tm.named_buffers()}, tm)["params"],
                jgrads, "grad")
    _close_tree(to_jax_params(tm.state_dict(), tm)["batch_stats"], jstats, "batch_stats")
    with torch.no_grad():
        np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).numpy(), np.asarray(jeval), **TOL)


def test_io_round_trip_is_exact():
    for name, size in (("mlp", 9), ("cnn", 9), ("basic", 8), ("bottleneck", 16)):
        jm, tm, v, x, _ = _setup(name, size)
        flax_tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        assert jax.tree.structure(v) == jax.tree.structure(flax_tree), name
        for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(flax_tree)):
            assert a.shape == b.shape, name
        sd = from_jax_params(v, tm)
        assert sd.keys() == tm.state_dict().keys()
        for k, t in tm.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), err_msg=k)
        for a, b in zip(jax.tree.leaves(to_jax_params(sd, tm)), jax.tree.leaves(v)):
            np.testing.assert_array_equal(a, b)


def test_same_padding_is_xla_same():
    """(before, after) pads of the reference's SAME convs and pool:
    asymmetric on even sizes for stride 2, symmetric otherwise."""
    assert same_pads(224, 7, 2) == (2, 3)  # ImageNet stem conv
    assert same_pads(112, 3, 2) == (0, 1)  # stem max pool, strided 3x3 on even input
    assert same_pads(113, 3, 2) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)  # strided 1x1 projection
    assert same_pads(32, 3, 1) == (1, 1)
    x = np.random.default_rng(0).normal(size=(1, 10, 10, 2)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 2, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tresnet.Conv2dSame(2, 4, 3, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_init_statistics_follow_flax():
    """ResNet-18 (cifar stem, 16 filters): per-layer kernel standard
    deviations within 10% of flax's (the smallest kernel has 432 values, a
    ~3.4% standard error of the std), the same truncation at 2 std, the last
    BatchNorm of each block at scale 0, unit BN scales elsewhere, zero
    biases and running stats at 0 / 1."""
    jm = jresnet.ResNet18(num_classes=10, num_filters=16, stem="cifar")
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    tm = tresnet.ResNet18(num_classes=10, num_filters=16, stem="cifar",
                          generator=torch.Generator().manual_seed(0))
    mine = to_jax_params(tm.state_dict(), tm)
    assert jax.tree.structure(mine) == jax.tree.structure(v)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine), jax.tree.leaves(v)):
        b = np.asarray(b)
        assert a.shape == b.shape, path
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            assert a.std() == pytest.approx(b.std(), rel=0.1), name
            fan_in = np.prod(a.shape[:-1])
            assert np.abs(a).max() <= 2 / np.sqrt(fan_in) / 0.87962566 * (1 + 1e-6), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
