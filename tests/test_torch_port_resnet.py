"""PyTorch port: the ResNet slice against the JAX package, on the CPU.

The same numpy inputs and weights (fixed seeds) go through the JAX layer
or model and the port's (``load_jax_params`` / ``load_jax_state``):

- layers, each against its JAX twin: ``Convolution2D`` (1×1, 3×3 s1/s2
  ``same``, 7×7 s2, dilation, integer padding, bias, groups, channels
  first), ``ZeroPadding2D``, ``SpaceToDepth`` and ``stem_7x7_to_s2d``,
  windowed pooling (valid, same, explicit padding), global pooling,
  ``BatchNormalization`` in training (output and new state) and in eval,
  ``merge`` in every mode;
- the graph ``Model``: a narrow bottleneck graph built with the port's
  ``_bottleneck`` in training and eval, its fused and unfused routes, and
  the fusion plan (33 pairs in ResNet-50, 1 in ResNet-18, nothing fused
  in eval);
- ResNet-50 at 32×32×3 with 10 classes, batch 2: eval (ImageNet stem) and
  one training forward (CIFAR stem: with the ImageNet stem the last
  stage's BNs see two values a channel, below f32 resolution), and the
  ImageNet stem alone in training;
- ``Estimator.fit`` of the bottleneck graph (SGD with momentum, 4 steps of
  8): the loss at every step, the trained parameters and the moving
  statistics; then ``evaluate`` and ``predict`` on the moving statistics;
- ``load_torch_resnet`` against the JAX package's on one seeded
  torchvision-layout state dict, and the param / state trees round trip.

Each tolerance is stated where it is used, with its reason.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.models import imageclassification as jic
from analytics_zoo_tpu.nn import graph as jgraph
from analytics_zoo_tpu.nn import models as jmodels
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.layers import conv as jconv
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.models import imageclassification as tic
from analytics_zoo_tpu_torch.nn import graph as tgraph
from analytics_zoo_tpu_torch.nn import models as tmodels
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import conv as tconv
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import pooling as tpool
from analytics_zoo_tpu_torch.ops import fused_bn as tfb
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   export_state,
                                                   load_jax_params,
                                                   load_jax_state)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """Both packages at the f32 dtype policy the tolerances here assume
    (each policy is process-global; a benchmark run in-process in the same
    worker may leave the JAX package's at bf16)."""
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = _np(v)
    return out


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _seeded(layer, seed):
    """Draw the port layer's parameters from ``seed`` and give BatchNorm
    layers non-trivial gamma, beta and moving statistics; returns the
    (params, state) trees as numpy for the JAX side."""
    layer.init_weights(seed)
    g = np.random.default_rng(seed)
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, tcore.BatchNormalization):
                d = m.gamma.shape[0]
                m.gamma.copy_(torch.from_numpy(
                    g.uniform(0.5, 1.5, d).astype(np.float32)))
                m.beta.copy_(torch.from_numpy(
                    g.normal(0, 0.1, d).astype(np.float32)))
                m.mean.copy_(torch.from_numpy(
                    g.normal(0, 0.1, d).astype(np.float32)))
                m.var.copy_(torch.from_numpy(
                    g.uniform(0.5, 2.0, d).astype(np.float32)))
    return _tree_np(export_params(layer)), _tree_np(export_state(layer))


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- layers --------------------------------------------------------------------

# f32 convolutions and pools on both sides; only the summation order of the
# conv differs (XLA vs oneDNN), read at 4.8e-7 on outputs up to 4.1
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)

CONV_CASES = {
    "1x1_s1_same": dict(nb_filter=6, kernel_size=1, border_mode="same",
                        bias=False),
    "3x3_s1_same": dict(nb_filter=6, kernel_size=3, border_mode="same"),
    "3x3_s2_same": dict(nb_filter=6, kernel_size=3, subsample=2,
                        border_mode="same", activation="relu"),
    "7x7_s2_same": dict(nb_filter=5, kernel_size=7, subsample=2,
                        border_mode="same", bias=False),
    "3x3_valid_dilated": dict(nb_filter=4, kernel_size=3, dilation=2),
    "int_padding": dict(nb_filter=6, kernel_size=3, border_mode=1,
                        subsample=2),
    "tuple_padding": dict(nb_filter=6, kernel_size=(3, 5),
                          border_mode=(2, 1)),
    "groups": dict(nb_filter=6, kernel_size=3, border_mode="same",
                   groups=2, activation="tanh"),
    "channels_first": dict(nb_filter=6, kernel_size=3, subsample=2,
                           border_mode="same", dim_ordering="th"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("hw", [(12, 12), (11, 10)])
def test_conv2d_matches_jax(case, hw):
    kw = CONV_CASES[case]
    th = kw.get("dim_ordering") == "th"
    shape = (4,) + hw if th else hw + (4,)
    x = _x(1, (2,) + shape)
    tl = tconv.Convolution2D(input_shape=shape, name="c", **kw)
    params, _ = _seeded(tl, 3)
    jl = jconv.Convolution2D(name="c", **kw)
    want = np.asarray(jl.call(params, x))
    got = _np(tl(torch.from_numpy(x)))
    assert got.shape == want.shape
    assert tuple(tl.compute_output_shape(shape)) == want.shape[1:]
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_conv_refuses_quantized_leaves():
    """A conv takes a well-formed quantized leaf set (int8 ``{W_q, s_w,
    s_x, b}``: it switches form, exports those leaves and is no longer
    fusable with BN) and refuses a malformed one or float weights once
    quantized."""
    conv = tconv.Convolution2D(4, 1, input_shape=(4, 4, 8), name="c")
    leaves = {"W_q": np.ones((1, 1, 8, 4), np.int8),
              "s_w": np.ones(4, np.float32), "s_x": np.float32(0.1),
              "b": np.zeros(4, np.float32)}
    bad = tconv.Convolution2D(4, 1, input_shape=(4, 4, 8), name="d")
    with pytest.raises(KeyError, match="s_x"):
        load_jax_params(bad, {k: v for k, v in leaves.items()
                              if k != "s_x"})
    with pytest.raises(ValueError, match="W_q must be"):
        load_jax_params(bad, dict(leaves, W_q=np.ones((1, 1, 4, 8),
                                                       np.int8)))
    load_jax_params(conv, leaves)
    assert conv.bits == 8 and not conv.fusable_with_bn()
    assert sorted(export_params(conv)) == ["W_q", "b", "s_w", "s_x"]
    with pytest.raises(ValueError, match="float weights back"):
        load_jax_params(conv, {"W": np.ones((1, 1, 8, 4), np.float32),
                               "b": np.zeros(4, np.float32)})


@pytest.mark.parametrize("padding", [(1, 1), (2, 0), ((0, 1), (2, 3))])
@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_zero_padding2d_matches_jax(padding, ordering):
    x = _x(2, (2, 3, 5, 4))
    want = np.asarray(jconv.ZeroPadding2D(padding, dim_ordering=ordering)
                      .call({}, x))
    tl = tconv.ZeroPadding2D(padding, dim_ordering=ordering)
    np.testing.assert_array_equal(_np(tl(torch.from_numpy(x))), want)
    assert tl.compute_output_shape(x.shape[1:]) == want.shape[1:]


def test_space_to_depth_and_stem_mapping_match_jax():
    """``SpaceToDepth`` bitwise; ``stem_7x7_to_s2d`` maps the weights as
    the JAX package does (bitwise), and the 4×4/s1 conv over the folded
    input equals the 7×7/s2 SAME conv (f32 conv tolerance)."""
    x = _x(4, (2, 16, 16, 3))
    want = np.asarray(jconv.SpaceToDepth(2).call({}, x))
    s2d = tconv.SpaceToDepth(2)
    got = s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), want)
    assert s2d.compute_output_shape((16, 16, 3)) == (8, 8, 12)
    w7 = _x(5, (7, 7, 3, 8))
    w4 = tconv.stem_7x7_to_s2d(torch.from_numpy(w7))
    np.testing.assert_array_equal(_np(w4),
                                  np.asarray(jconv.stem_7x7_to_s2d(w7)))
    c7 = tconv.Convolution2D(8, 7, subsample=2, border_mode="same",
                             bias=False, input_shape=(16, 16, 3))
    c4 = tconv.Convolution2D(8, 4, border_mode="same", bias=False,
                             input_shape=(8, 8, 12))
    load_jax_params(c7, {"W": w7})
    load_jax_params(c4, {"W": _np(w4)})
    np.testing.assert_allclose(_np(c4(got)), _np(c7(torch.from_numpy(x))),
                               **LAYER_TOL)


POOL_CASES = {
    "max_valid": (2, dict(pool_size=2)),
    "max_same_s2": (2, dict(pool_size=3, strides=2, border_mode="same")),
    "max_explicit": (2, dict(pool_size=3, strides=2,
                             padding=((1, 1), (1, 1)))),
    "max_explicit_asym": (2, dict(pool_size=2, strides=1,
                                  padding=((0, 1), (1, 0)))),
    "avg_valid_s1": (2, dict(pool_size=3, strides=1)),
    "avg_same_s2": (2, dict(pool_size=3, strides=2, border_mode="same")),
    "avg_explicit": (2, dict(pool_size=2, padding=((1, 0), (0, 1)))),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("size", [8, 7])
def test_pooling_matches_jax(case, size):
    """Max pads with -inf and average with 0, and an average divides by the
    full window, as ``lax.reduce_window`` does."""
    ndim, kw = POOL_CASES[case]
    op = "Max" if case.startswith("max") else "Average"
    cls = f"{op}Pooling{ndim}D"
    shape = (size,) * ndim + (3,)
    x = _x(6, (2,) + shape)
    want = np.asarray(getattr(jpool, cls)(**kw).call({}, x))
    tl = getattr(tpool, cls)(**kw)
    got = _np(tl(torch.from_numpy(x)))
    assert got.shape == want.shape
    assert tl.compute_output_shape(shape) == want.shape[1:]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cls", ["GlobalAveragePooling2D",
                                 "GlobalMaxPooling2D"])
@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_global_pooling_2d_matches_jax(cls, ordering):
    x = _x(7, (2, 5, 6, 4))
    want = np.asarray(getattr(jpool, cls)(dim_ordering=ordering)
                      .call({}, x))
    tl = getattr(tpool, cls)(dim_ordering=ordering)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), want,
                               atol=1e-6, rtol=1e-6)
    assert tl.compute_output_shape(x.shape[1:]) == want.shape[1:]


# BatchNorm: the same single-pass f32 statistics in another summation
# order (outputs read at 1.9e-6 on values up to ~5); the moving statistics
# move by 1 - momentum of the batch's, read at 2.4e-7
BN_OUT_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,axis", [((4, 5, 6, 8), -1), ((16, 8), -1),
                                        ((4, 8, 5, 6), 1)])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(shape, axis, training):
    x = _x(8, shape) * 2.0 + 0.5
    tl = tcore.BatchNormalization(axis=axis, momentum=0.9,
                                  input_shape=shape[1:], name="bn")
    params, state = _seeded(tl, 9)
    jl = jcore.BatchNormalization(axis=axis, momentum=0.9, name="bn")
    want, want_state = jl.apply(params, state, x, training=training)
    tl.train(training)
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **BN_OUT_TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(export_state(tl)[k]),
                                   np.asarray(want_state[k]), **STATE_TOL)


def test_batchnorm_precomputed_sums_equal_its_own():
    """``forward(x, stats=(Σ, Σ², n))`` with the sums BN would take itself
    gives the same output and state update."""
    x = torch.from_numpy(_x(10, (3, 4, 4, 5)))
    a = tcore.BatchNormalization(input_shape=(4, 4, 5)).train()
    b = tcore.BatchNormalization(input_shape=(4, 4, 5)).train()
    x2 = x.reshape(-1, 5)
    ya = a(x)
    yb = b(x, stats=(x2.sum(0), (x2 * x2).sum(0), x2.shape[0]))
    torch.testing.assert_close(yb, ya, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b.mean, a.mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(b.var, a.var, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "sub", "max", "min",
                                  "concat", "dot", "cos"])
def test_merge_matches_jax(mode):
    xs = [_x(11 + i, (3, 4, 5)) for i in range(2 if mode in (
        "sub", "dot", "cos") else 3)]
    want = np.asarray(jcore.Merge(mode=mode).call({}, xs))
    tl = tcore.Merge(mode=mode)
    got = _np(tl([torch.from_numpy(a) for a in xs]))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert tl.compute_output_shape([a.shape[1:] for a in xs]) \
        == want.shape[1:]


# -- the graph Model -------------------------------------------------------------

def _bottleneck_graph(mod_ic, mod_graph, mod_models, mod_core, mod_pool):
    """Input (8, 8, 8) -> a downsampling bottleneck (filters 4, stride 1:
    its downsample is a fusable 1×1) -> a stride-2 bottleneck -> global
    pool -> Dense(3, softmax), with the package's own helpers."""
    inp = mod_graph.Input(shape=(8, 8, 8), name="g_input")
    x = mod_ic._bottleneck(inp, 4, 1, "g_s0b0", downsample=True)
    x = mod_ic._bottleneck(x, 4, 2, "g_s1b0", downsample=True)
    x = mod_pool.GlobalAveragePooling2D(name="g_gap")(x)
    x = mod_core.Dense(3, activation="softmax", name="g_fc")(x)
    return mod_models.Model(input=inp, output=x, name="g")


def _graph_pair(seed=20):
    tm = _bottleneck_graph(tic, tgraph, tmodels, tcore, tpool)
    params, state = _seeded(tm, seed)
    jm = _bottleneck_graph(jic, jgraph, jmodels, jcore, jpool)
    return tm, jm, params, state


def test_graph_model_trees_match_jax_layout():
    """The port's param and state trees have the JAX package's keys and
    shapes, layer by layer."""
    tm, jm, params, state = _graph_pair()
    jp, js = jm.init(jax.random.PRNGKey(0))
    for got, want in ((params, jp), (state, js)):
        g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
        assert sorted(g) == sorted(w)
        for path in w:
            assert g[path].shape == w[path].shape, path
    assert tm.param_count() == sum(int(np.prod(a.shape))
                                   for a in jax.tree.leaves(jp))


@pytest.mark.parametrize("training", [True, False])
def test_graph_model_matches_jax(training):
    """Forward and new state of the bottleneck graph against the JAX
    ``Model.apply``: softmax probabilities, read at 1.5e-7; new state
    1.2e-7."""
    tm, jm, params, state = _graph_pair()
    x = _x(21, (4, 8, 8, 8))
    want, want_state = jm.apply(params, state, x, training=training)
    tm.train(training)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    w, g = _leaves(want_state), _leaves(export_state(tm))
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path,
                                   **STATE_TOL)


def test_fused_and_unfused_routes_agree():
    """In training, the fused route (``ops/fused_bn``'s plain version on the
    CPU) and the unfused one (conv, then BN's own sums) give the same
    output, new state and gradients up to f32 summation order."""
    results = []
    for fuse in (True, False):
        tm, _, _, _ = _graph_pair()
        if not fuse:
            tm.fusion_plan = ()
        tm.train()
        x = torch.from_numpy(_x(22, (4, 8, 8, 8)))
        y = tm(x)
        (y * torch.from_numpy(_x(23, tuple(y.shape)))).sum().backward()
        results.append((y.detach(), _leaves(export_state(tm)),
                        {n: p.grad.clone() for n, p
                         in tm.named_parameters()}))
    (y1, s1, g1), (y2, s2, g2) = results
    torch.testing.assert_close(y1, y2, atol=1e-6, rtol=1e-5)
    for path in s1:
        np.testing.assert_allclose(s1[path], s2[path], err_msg=path,
                                   **STATE_TOL)
    for name in g1:
        torch.testing.assert_close(g1[name], g2[name], atol=1e-5, rtol=1e-4,
                                   msg=name)


def _count_fused(monkeypatch):
    calls = []
    real = tconv._ConvND.fused_bn_forward

    def counted(self, x):
        calls.append(self.name)
        return real(self, x)
    monkeypatch.setattr(tconv._ConvND, "fused_bn_forward", counted)
    return calls


def test_fusion_plan_runs_in_training_only(monkeypatch):
    """Training runs every planned pair fused, once per forward; eval runs
    none (the BN reads its moving statistics)."""
    tm, _, _, _ = _graph_pair()
    plan = sorted((c.layer.name, b.layer.name) for c, b in tm.fusion_plan)
    assert plan == [("g_s0b0_1_conv", "g_s0b0_1_bn"),
                    ("g_s0b0_3_conv", "g_s0b0_3_bn"),
                    ("g_s0b0_down_conv", "g_s0b0_down_bn"),
                    ("g_s1b0_1_conv", "g_s1b0_1_bn"),
                    ("g_s1b0_3_conv", "g_s1b0_3_bn")]
    calls = _count_fused(monkeypatch)
    x = torch.from_numpy(_x(24, (2, 8, 8, 8)))
    tm.train()
    tm(x)
    assert sorted(calls) == sorted(c for c, _ in plan)
    calls.clear()
    tm.eval()
    with torch.no_grad():
        tm(x)
    assert calls == []


@pytest.mark.parametrize("depth,pairs", [(50, 33), (18, 1)])
def test_resnet_fusion_plan_length(depth, pairs):
    """ResNet-50: each bottleneck's ``_1`` and ``_3`` (16 × 2) and stage 0's
    stride-1 downsample; ResNet-18: stage 0's downsample alone.  No forward
    needed."""
    m = tic.resnet(depth, 10, (32, 32, 3))
    assert len(m.fusion_plan) == pairs
    names = {c.layer.name for c, _ in m.fusion_plan}
    assert f"resnet{depth}_s0b0_down_conv" in names
    assert all(not c.layer.bias and c.layer.kernel_size == (1, 1)
               and c.layer.subsample == (1, 1) for c, _ in m.fusion_plan)


def test_fusion_plan_skips_convs_it_cannot_compute():
    """Not fused: a 1×1 conv with a bias, a linear conv whose output also
    feeds a second layer, a conv that is a model output, a BN over
    another axis."""
    inp = tgraph.Input(shape=(4, 4, 6))
    a = tconv.Convolution2D(6, 1, bias=True, name="biased")(inp)
    a = tcore.BatchNormalization(name="bn_a")(a)
    b = tconv.Convolution2D(6, 1, bias=False, name="shared_out")(a)
    c = tcore.BatchNormalization(name="bn_b")(b)
    d = tcore.merge([b, c], name="m")
    e = tconv.Convolution2D(6, 1, bias=False, name="axis1")(d)
    e = tcore.BatchNormalization(axis=1, name="bn_axis1")(e)
    f = tconv.Convolution2D(6, 1, bias=False, name="ok")(e)
    f = tcore.BatchNormalization(name="bn_ok")(f)
    g = tconv.Convolution2D(6, 1, bias=False, name="last")(f)
    m = tmodels.Model(input=inp, output=g)
    assert [(c.layer.name, b.layer.name) for c, b in m.fusion_plan] == [
        ("ok", "bn_ok")]


def test_selected_fused_kernel_failure_propagates(monkeypatch):
    """No fallback: with the kernel selected (the resolver answers "cuda")
    a failing launch raises out of the training forward."""
    class _KernelDown(RuntimeError):
        pass

    def down(*args, **kwargs):
        raise _KernelDown("launch failed")
    monkeypatch.setattr(tfb, "resolve_impl", lambda impl, x: "cuda")
    monkeypatch.setattr(tfb, "_fused_bn_cuda", down)
    tm, _, _, _ = _graph_pair()
    tm.train()
    with pytest.raises(_KernelDown):
        tm(torch.from_numpy(_x(25, (2, 8, 8, 8))))


# -- whole ResNet-50 -------------------------------------------------------------

def _resnet50_pair(stem):
    tm = tic.resnet(50, 10, (32, 32, 3), stem=stem)
    params, state = _seeded(tm, 30)
    jm = jic.resnet(50, 10, (32, 32, 3), stem=stem)
    return tm, jm, params, state


def test_resnet50_eval_matches_jax():
    """ResNet-50 (ImageNet stem: 7×7/s2 conv padded (2, 3), 3×3/s2
    max-pool padded (0, 1) with -inf) at 32×32×3, 10 classes, batch 2, in
    eval mode on seeded moving statistics: softmax outputs, f32 noise of
    53 convolutions (read at 0 here)."""
    tm, jm, params, state = _resnet50_pair("imagenet")
    x = _x(31, (2, 32, 32, 3))
    want, _ = jm.apply(params, state, x, training=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_resnet50_training_forward_matches_jax():
    """One training forward of ResNet-50 at 32×32×3, 10 classes, batch 2,
    through the fused route (33 pairs): output and every BN's new state.

    With the ImageNet stem the last stage is 1×1 at 32×32, so each of its
    BNs normalises two values a channel whose biased variance is ~3e-9 of
    their squared mean, below f32 resolution: there the JAX package's own
    f32 forward reads 7.9e-3 from a float64 evaluation (the port's
    3.7e-2), and no f32 comparison near 1e-5 is meaningful.  The CIFAR
    stem (3×3/s1, no pool) keeps 4×4 in the last stage, 32 values a
    channel.  Still, BN in training mode
    re-normalises f32 noise at each of 53 layers: softmax outputs read at
    3.0e-5, new state at 4.2e-6; atol 1e-4 and 2e-5.  The ImageNet stem is
    held in training by ``test_imagenet_stem_training_matches_jax``; the
    conditioning by
    ``test_resnet50_imagenet_stem_training_is_below_f32_resolution``."""
    tm, jm, params, state = _resnet50_pair("cifar")
    assert len(tm.fusion_plan) == 33
    x = _x(31, (2, 32, 32, 3))
    want, want_state = jm.apply(params, state, x, training=True)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    w, g = _leaves(want_state), _leaves(export_state(tm))
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path,
                                   atol=2e-5, rtol=1e-5)


def test_resnet50_imagenet_stem_training_is_below_f32_resolution():
    """Why the training forward above takes the CIFAR stem: with the
    ImageNet stem at 32×32, batch 2, the last stage is 1×1, so each of its
    BNs normalises two values a channel, and in some channel their biased
    variance is below f32's resolution of their squared mean (var / mean²
    < 2**-24).  There the JAX package's own f32 training forward is more
    than 1e-3 from the same forward in float64 (the port's graph with
    float64 weights, statistics and products, unfused; read 7.9e-3), so
    no f32 comparison near 1e-5 can hold."""
    tm, jm, params, state = _resnet50_pair("imagenet")
    m64 = copy.deepcopy(tm).double()
    m64.fusion_plan = ()
    ratios = []

    def hook(mod, args, out):
        if mod.name.startswith("resnet50_s3"):
            v = args[0].detach().double().reshape(-1, args[0].shape[-1])
            ratios.append(float((v.var(0, unbiased=False)
                                 / v.mean(0) ** 2).min()))
    handles = [m.register_forward_hook(hook) for m in tm.modules()
               if isinstance(m, tcore.BatchNormalization)]
    x = _x(31, (2, 32, 32, 3))
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for h in handles:
        h.remove()
    assert min(ratios) < 2.0 ** -24
    want, _ = jm.apply(params, state, x, training=True)
    tdtypes.set_policy(None, torch.float64)
    try:
        m64.train()
        with torch.no_grad():
            got64 = m64(torch.from_numpy(x).double())
    finally:
        tdtypes.set_policy(None)
    assert np.abs(np.asarray(want) - _np(got64)).max() > 1e-3


def _stem_graph(mod_ic, mod_graph, mod_models, mod_pool):
    inp = mod_graph.Input(shape=(32, 32, 3), name="s_input")
    x = mod_ic._conv_bn(inp, 8, 7, 2, "s_stem")
    x = mod_pool.MaxPooling2D(3, strides=2, border_mode="same",
                              name="s_pool")(x)
    return mod_models.Model(input=inp, output=x, name="s")


def test_imagenet_stem_training_matches_jax():
    """The ImageNet stem (7×7/s2 SAME conv padded (2, 3), BN in training,
    ReLU, 3×3/s2 SAME max-pool padded (0, 1) with -inf) at 32×32, batch 2:
    output and new state at the layer tolerances."""
    tm = _stem_graph(tic, tgraph, tmodels, tpool)
    params, state = _seeded(tm, 32)
    jm = _stem_graph(jic, jgraph, jmodels, jpool)
    x = _x(33, (2, 32, 32, 3))
    want, want_state = jm.apply(params, state, x, training=True)
    tm.train()
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), **BN_OUT_TOL)
    for path, w in _leaves(want_state).items():
        np.testing.assert_allclose(_leaves(export_state(tm))[path], w,
                                   err_msg=path, **STATE_TOL)


# -- Estimator.fit ----------------------------------------------------------------

N_IMG, BATCH = 32, 8


@pytest.fixture(scope="module")
def fitted():
    """The JAX and the port's Estimator, each fit for one epoch (4 steps of
    8) of SGD(0.05, momentum 0.9) from the same weights, state, data and
    shuffle seed (42)."""
    tm, jm, params, state = _graph_pair(40)
    jm.set_weights(params, state)
    g = np.random.default_rng(41)
    y = g.integers(0, 3, N_IMG).astype(np.int32)
    x = (g.normal(size=(N_IMG, 8, 8, 8))
         + y[:, None, None, None] * 0.5).astype(np.float32)
    jax_context().set_seed(42)
    je = JaxEstimator(jm, optimizer=jopt.SGD(0.05, momentum=0.9),
                      loss="sparse_categorical_crossentropy")
    te = Estimator(tm, optimizer=topt.SGD(0.05, momentum=0.9),
                   loss="sparse_categorical_crossentropy",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    je.fit(x, y, batch_size=BATCH, epochs=1, verbose=False)
    te.fit(x, y, batch_size=BATCH, epochs=1, verbose=False)
    return dict(je=je, te=te, tm=tm, x=x, y=y, losses=losses)


def test_fit_loss_per_step_matches_jax(fitted):
    """The same 4 batches in the same order: each step's loss (1.58 falling
    to 0.67), f32 noise read at 3.6e-7."""
    lj, lp = fitted["losses"]["jax"], fitted["losses"]["port"]
    assert len(lj) == len(lp) == N_IMG // BATCH
    np.testing.assert_allclose(lp, lj, atol=1e-5)
    assert fitted["tm"].training is False


def test_fit_trained_params_and_moving_stats_match_jax(fitted):
    """Leaf by leaf after 4 SGD steps (no per-element normalisation, so f32
    noise stays at its size: read at 1.2e-7 on parameters): atol 1e-5;
    the moving statistics, updated once per step, 1e-6 (read 3.6e-7)."""
    want = _leaves(jax.tree.map(np.asarray, fitted["je"].params))
    got = _leaves(export_params(fitted["tm"]))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5,
                                   err_msg=path)
    want = _leaves(jax.tree.map(np.asarray, fitted["je"].state))
    got = _leaves(export_state(fitted["tm"]))
    assert sorted(got) == sorted(want) and want
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **STATE_TOL)


def test_evaluate_and_predict_after_fit_match_jax(fitted):
    """Eval mode on the moving statistics: loss to 1e-5 (read 2.4e-7),
    probabilities to 1e-6 (read 2.4e-7)."""
    x, y = fitted["x"], fitted["y"]
    ej = fitted["je"].evaluate(x, y, batch_size=BATCH)
    ep = fitted["te"].evaluate(x, y, batch_size=BATCH)
    assert ep["loss"] == pytest.approx(ej["loss"], abs=1e-5)
    pj = fitted["je"].predict(x[:11], batch_size=BATCH)
    pp = fitted["te"].predict(x[:11], batch_size=BATCH)
    assert pp.shape == pj.shape == (11, 3)
    np.testing.assert_allclose(pp, pj, atol=1e-6)


# -- import and conversion -----------------------------------------------------------

def _torch_state_dict(seed, blocks, bottleneck, classes):
    """A seeded torchvision-layout ResNet state dict, built by key names."""
    g = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = g.normal(0, 0.1, (cout, cin, k, k)).astype(
            np.float32)

    def bn(key, c):
        sd[key + ".weight"] = g.uniform(0.5, 1.5, c).astype(np.float32)
        sd[key + ".bias"] = g.normal(0, 0.1, c).astype(np.float32)
        sd[key + ".running_mean"] = g.normal(0, 0.1, c).astype(np.float32)
        sd[key + ".running_var"] = g.uniform(0.5, 2, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin, width = 64, 64
    for st, n in enumerate(blocks):
        for b in range(n):
            pre = f"layer{st + 1}.{b}"
            cout = width * 4 if bottleneck else width
            if bottleneck:
                conv(f"{pre}.conv1", width, cin, 1)
                conv(f"{pre}.conv2", width, width, 3)
                conv(f"{pre}.conv3", cout, width, 1)
                for i, c in ((1, width), (2, width), (3, cout)):
                    bn(f"{pre}.bn{i}", c)
            else:
                conv(f"{pre}.conv1", width, cin, 3)
                conv(f"{pre}.conv2", width, width, 3)
                bn(f"{pre}.bn1", width)
                bn(f"{pre}.bn2", width)
            if b == 0 and (cin != cout or st > 0):
                conv(f"{pre}.downsample.0", cout, cin, 1)
                bn(f"{pre}.downsample.1", cout)
            cin = cout
        width *= 2
    sd["fc.weight"] = g.normal(0, 0.1, (classes, cin)).astype(np.float32)
    sd["fc.bias"] = g.normal(0, 0.1, classes).astype(np.float32)
    return sd


@pytest.mark.parametrize("depth,stem,as_tensors", [
    (18, "imagenet", True), (50, "s2d", False)])
def test_load_torch_resnet_matches_jax(depth, stem, as_tensors):
    """The same seeded state dict imported by both packages gives equal
    param and state trees (bitwise: copies and transposes; the s2d stem's
    weight mapping included; ResNet-18's identity shortcut set exactly)."""
    kind, blocks = tic._RESNET_SPECS[depth]
    sd = _torch_state_dict(50 + depth, blocks, kind == "bottleneck", 10)
    tm = tic.resnet(depth, 10, (32, 32, 3), stem=stem, padding="same")
    params, state = _seeded(tm, 51)
    jm = jic.resnet(depth, 10, (32, 32, 3), stem=stem)
    jm.set_weights(params, state)
    jic.load_torch_resnet(jm, sd, name=f"resnet{depth}", blocks=blocks,
                          stem=stem, bn_eps=1e-3)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()} if as_tensors \
        else sd
    tic.load_torch_resnet(tm, tsd, name=f"resnet{depth}", blocks=blocks,
                          stem=stem, bn_eps=1e-3)
    for got, want in ((export_params(tm), jm.get_weights()),
                      (export_state(tm), jm._state)):
        g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
        assert sorted(g) == sorted(w)
        for path in w:
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)


def test_param_and_state_trees_round_trip():
    """``export_params`` / ``export_state`` of one model, loaded into
    another built from other seeds, reproduce it exactly; a missing state
    leaf raises."""
    a = tic.resnet(18, 10, (32, 32, 3))
    params, state = _seeded(a, 60)
    b = tic.resnet(18, 10, (32, 32, 3))
    _seeded(b, 61)
    b.set_weights(params, state)
    for x, y in ((export_params(a), export_params(b)),
                 (export_state(a), export_state(b))):
        lx, ly = _leaves(x), _leaves(y)
        assert sorted(lx) == sorted(ly)
        for path in lx:
            np.testing.assert_array_equal(lx[path], ly[path], err_msg=path)
    del state["resnet18_stem_bn"]["var"]
    with pytest.raises(KeyError, match="state tree lacks"):
        load_jax_state(b, state)


def test_image_classifier_facade():
    """``ImageClassifier("resnet50").model`` is the 1000-class ResNet-50
    (25.6 M parameters, 33 fused pairs) on the device asked for, with the
    registry's ImageNet preprocessing; with no device and no CUDA it
    raises."""
    ic = tic.ImageClassifier("resnet50", device="cpu")
    assert isinstance(ic.model, tmodels.Model)
    assert ic.model.param_count() == 25_557_032
    assert len(ic.model.fusion_plan) == 33
    assert next(ic.model.parameters()).device.type == "cpu"
    assert ic.model.compute_output_shape(None) == (1000,)
    assert [type(t).__name__ for t in ic.preprocessor.stages] == [
        "ImageResize", "ImageCenterCrop", "ImageChannelNormalize"]
    with pytest.raises(ValueError, match="VARIANT"):
        tic.ImageClassifier("wide_resnet50", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tic.ImageClassifier("resnet18", input_shape=(32, 32, 3))
