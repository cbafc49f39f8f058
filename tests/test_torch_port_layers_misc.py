"""PyTorch port: ``nn/keras2.py``, ``nn/layers/advanced.py``,
``math.py``, ``embedding.py``, ``moe.py``, ``core.Merge`` with branch
layers and ``nn/autograd.py`` against the JAX package, on the CPU.

Each layer gets the same numpy inputs (fixed seeds) and the same weights
(the port layer's own draw, exported in the JAX layout) as its JAX twin;
outputs and the gradients of Σ y·r with respect to every parameter and
the float inputs are compared within LAYER_TOL (1e-5: f32 summation
order; ``torch_layer_parity``).  Graphs (the merge classes, the table
layers, autograd expressions) are built through both packages' graph DSL
and compared the same way.  What draws random numbers (``RReLU``,
``GaussianSampler``, the spatial dropouts) is compared in eval mode and
by its statistics in training mode.  ``keras2`` and ``autograd`` import
with jax absent.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import autograd as jag
from analytics_zoo_tpu.nn import graph as jgraph
from analytics_zoo_tpu.nn import keras2 as jk2
from analytics_zoo_tpu.nn import models as jmodels
from analytics_zoo_tpu.nn.layers import advanced as jadv
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import embedding as jemb
from analytics_zoo_tpu.nn.layers import math as jmath
from analytics_zoo_tpu.nn.layers import moe as jmoe
from analytics_zoo_tpu_torch.nn import autograd as tag
from analytics_zoo_tpu_torch.nn import graph as tgraph
from analytics_zoo_tpu_torch.nn import keras2 as tk2
from analytics_zoo_tpu_torch.nn import models as tmodels
from analytics_zoo_tpu_torch.nn.layers import advanced as tadv
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import embedding as temb
from analytics_zoo_tpu_torch.nn.layers import math as tmath
from analytics_zoo_tpu_torch.nn.layers import moe as tmoe
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_state)
from torch_layer_parity import (LAYER_TOL, check_layer, f32_policy,
                                params_np, to_np, tree_np)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    with f32_policy():
        yield


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _randomize(layer, seed):
    """Every parameter of the port layer drawn N(0, 0.5²): the layers'
    constant initial values (PReLU's 0.25, SReLU's thresholds, CMul's
    ones) would hide a swapped leaf."""
    g = np.random.default_rng(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(g.normal(0, 0.5, tuple(p.shape)).astype(
                np.float32)))
    return layer


def _graph_params(jmodel, tmodel):
    """The JAX graph's own param tree with every parametric layer's subtree
    replaced by the port model's (its parameter-free nodes are named
    differently in the two packages)."""
    jp, js = jmodel.init(jax.random.PRNGKey(0))
    tp = tree_np(export_params(tmodel))
    for k, v in tp.items():
        if v:
            assert k in jp, k
            jp[k] = v
    return jp, js


# -- keras2 ----------------------------------------------------------------------

def test_keras2_has_the_jax_constructors():
    import inspect

    def public(mod):
        return {n for n, o in vars(mod).items() if not n.startswith("_")
                and (inspect.isfunction(o) or inspect.isclass(o))
                and o.__module__ == mod.__name__}
    assert public(tk2) == public(jk2)


KERAS2_CASES = {
    "Dense": ((4,), dict(activation="relu"), (2, 6)),
    "Conv1D": ((4, 3), dict(strides=2, padding="same"), (2, 9, 3)),
    "Conv2D": ((4, 3), dict(strides=2, padding="same", use_bias=False),
               (2, 8, 8, 3)),
    "Conv2D_th": ((4, 3), dict(data_format="channels_first"),
                  (2, 3, 7, 7)),
    "Conv3D": ((3, 2), dict(strides=(1, 2, 2)), (2, 4, 5, 5, 2)),
    "DepthwiseConv2D": ((3,), dict(strides=2, padding="same",
                                   depth_multiplier=2), (2, 8, 8, 3)),
    "SeparableConv2D": ((4, 3), dict(padding="same"), (2, 6, 6, 3)),
    "Conv2DTranspose": ((3, 3), dict(strides=2, padding="same"),
                        (2, 4, 5, 2)),
    "LocallyConnected1D": ((3, 2), {}, (2, 6, 3)),
    "MaxPooling1D": ((2,), {}, (2, 6, 3)),
    "AveragePooling1D": ((3,), dict(strides=1, padding="same"), (2, 6, 3)),
    "MaxPooling2D": ((3,), dict(strides=2, padding="same"), (2, 7, 8, 2)),
    "AveragePooling2D": ((2,), {}, (2, 6, 6, 2)),
    "MaxPooling3D": ((2,), {}, (2, 4, 4, 4, 2)),
    "AveragePooling3D": ((2,), dict(padding="same", strides=1),
                         (2, 3, 4, 4, 2)),
    "GlobalMaxPooling1D": ((), {}, (2, 5, 3)),
    "GlobalAveragePooling1D": ((), {}, (2, 5, 3)),
    "GlobalMaxPooling2D": ((), {}, (2, 4, 5, 3)),
    "GlobalAveragePooling2D": ((), {}, (2, 4, 5, 3)),
    "GlobalMaxPooling3D": ((), {}, (2, 3, 4, 5, 3)),
    "GlobalAveragePooling3D": ((), {}, (2, 3, 4, 5, 3)),
    "UpSampling2D": (((2, 3),), {}, (2, 3, 4, 2)),
    "ZeroPadding2D": (((1, 2),), {}, (2, 3, 4, 2)),
    "Cropping1D": (((1, 2),), {}, (2, 6, 2)),
    "Cropping2D": ((((1, 0), (0, 2)),), {}, (2, 5, 6, 2)),
    "Flatten": ((), {}, (2, 3, 4)),
    "Reshape": (((4, 3),), {}, (2, 3, 4)),
    "Activation": (("relu6",), {}, (2, 5)),
    "Softmax": ((), {}, (2, 5)),
    "Dropout": ((0.5,), {}, (2, 5)),
    "BatchNormalization": ((), dict(momentum=0.9, epsilon=1e-2), (2, 3, 4)),
    "LSTM": ((4,), dict(return_sequences=True), (2, 5, 3)),
    "GRU": ((4,), dict(go_backwards=True), (2, 5, 3)),
    "SimpleRNN": ((3,), {}, (2, 5, 3)),
}


@pytest.mark.parametrize("case", sorted(KERAS2_CASES))
def test_keras2_constructors_match_jax(case):
    args, kw, shape = KERAS2_CASES[case]
    name = case.split("_")[0]
    tl = getattr(tk2, name)(*args, input_shape=shape[1:], name="k",
                            **kw)
    jl = getattr(jk2, name)(*args, name="k", **kw)
    if name != "BatchNormalization":
        _randomize(tl, 1)
    else:
        # eval mode: the moving statistics, drawn
        g = np.random.default_rng(2)
        state = {"mean": g.normal(size=4).astype(np.float32),
                 "var": g.uniform(0.5, 2, 4).astype(np.float32)}
        load_jax_state(tl, state)
        want, _ = jl.apply(params_np(tl), state, _x(3, shape))
        got = to_np(tl(torch.from_numpy(_x(3, shape))))
        np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)
        return
    want = check_layer(tl, jl, _x(3, shape))
    assert tuple(tl.compute_output_shape(shape[1:])) == \
        tuple(np.shape(want)[1:])


MERGE_CLASSES = ["Add", "Subtract", "Multiply", "Average", "Maximum",
                 "Minimum", "Concatenate", "Dot", "Dot_normalize"]


@pytest.mark.parametrize("case", MERGE_CLASSES)
def test_keras2_merge_classes_in_a_graph_match_jax(case):
    """Two Dense branches merged by the keras2 class and by its functional
    form, through both packages' graph Model."""
    name = case.split("_")[0]
    kw = dict(normalize=True) if case.endswith("normalize") else {}

    def build(k2, graph, models):
        a, b = graph.Input((5,), name="a"), graph.Input((5,), name="b")
        da = k2.Dense(4, activation="tanh", name="da")(a)
        db = k2.Dense(4, name="db")(b)
        m1 = getattr(k2, name)(name="m1", **kw)([da, db])
        fn = getattr(k2, name.lower())
        m2 = fn([db, da], name="m2", **kw)
        return models.Model(input=[a, b], output=[m1, m2])
    tm = build(tk2, tgraph, tmodels)
    _randomize(tm, 4)
    jm = build(jk2, jgraph, jmodels)
    jp, _ = _graph_params(jm, tm)
    xs = [_x(5, (3, 5)), _x(6, (3, 5))]
    want = jm.call(jp, xs)
    got = tm([torch.from_numpy(v) for v in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **LAYER_TOL)


# -- advanced ----------------------------------------------------------------------

ADV_CASES = {
    "LeakyReLU": (lambda m: m.LeakyReLU(0.2), (2, 3, 4)),
    "ELU": (lambda m: m.ELU(0.7), (2, 3, 4)),
    "ThresholdedReLU": (lambda m: m.ThresholdedReLU(0.4), (2, 3, 4)),
    "PReLU": (lambda m: m.PReLU, (2, 3, 4)),
    "SReLU": (lambda m: m.SReLU, (2, 3, 4)),
    "MaxoutDense": (lambda m: m.MaxoutDense(3, nb_feature=3), (2, 5)),
    "MaxoutDense_nobias": (lambda m: m.MaxoutDense(3, bias=False), (2, 5)),
    "SpatialDropout1D": (lambda m: m.SpatialDropout1D(0.5), (2, 4, 3)),
    "SpatialDropout2D": (lambda m: m.SpatialDropout2D(0.5), (2, 4, 4, 3)),
    "WithinChannelLRN2D": (lambda m: m.WithinChannelLRN2D(3, alpha=0.5),
                           (2, 5, 6, 3)),
    "WithinChannelLRN2D_even": (lambda m: m.WithinChannelLRN2D(4),
                                (2, 5, 6, 3)),
}


@pytest.mark.parametrize("case", sorted(ADV_CASES))
def test_advanced_layers_match_jax(case):
    build, shape = ADV_CASES[case]
    tl = build(tadv)
    if isinstance(tl, type):
        tl = tl(input_shape=shape[1:], name="l")
        jl = build(jadv)(name="l")
    else:
        tl.name = "l"
        tl.ensure_built(shape[1:])
        jl = build(jadv)
        jl.name = "l"
    _randomize(tl, 7)
    want = check_layer(tl, jl, _x(8, shape))
    assert tuple(tl.compute_output_shape(shape[1:])) == want.shape[1:]


@pytest.mark.parametrize("kind", ["1D", "2D", "2D_th"])
def test_spatial_dropout_drops_whole_channels(kind):
    """Training mode with a seed: each (sample, channel) is kept at rate
    1 - p and scaled by 1 / (1 - p), or zeroed, over every step of it."""
    if kind == "1D":
        layer, x = tadv.SpatialDropout1D(0.3), torch.ones(64, 5, 32)
        axes = (1,)
    else:
        th = kind.endswith("th")
        layer = tadv.SpatialDropout2D(0.3, dim_ordering="th" if th else "tf")
        x = torch.ones(64, 32, 4, 5) if th else torch.ones(64, 4, 5, 32)
        axes = (2, 3) if th else (1, 2)
    layer.train()
    layer.seed_dropout(3)
    y = layer(x)
    vals = torch.unique(y)
    assert set(vals.tolist()) <= {0.0, float(np.float32(1.0 / 0.7))}
    assert torch.all(y.amax(dim=axes) == y.amin(dim=axes))
    assert abs(float((y > 0).float().mean()) - 0.7) < 0.06
    layer.eval()
    assert torch.equal(layer(x), x)


# -- math ------------------------------------------------------------------------

MATH_CASES = {
    "AddConstant": (lambda m: m.AddConstant(1.5), 1.0),
    "MulConstant": (lambda m: m.MulConstant(-2.0), 1.0),
    "Negative": (lambda m: m.Negative(), 1.0),
    "Power": (lambda m: m.Power(3.0, scale=0.5, shift=0.25), 1.0),
    "Power_frac": (lambda m: m.Power(0.5, shift=5.0), 1.0),
    "Sqrt": (lambda m: m.Sqrt(), "pos"),
    "Square": (lambda m: m.Square(), 1.0),
    "Exp": (lambda m: m.Exp(), 1.0),
    "Log": (lambda m: m.Log(), "pos"),
    "Identity": (lambda m: m.Identity(), 1.0),
    "Softmax": (lambda m: m.Softmax(), 1.0),
    "BinaryThreshold": (lambda m: m.BinaryThreshold(0.1), 1.0),
    "Threshold": (lambda m: m.Threshold(0.2, -3.0), 1.0),
    "HardShrink": (lambda m: m.HardShrink(0.6), 1.0),
    "SoftShrink": (lambda m: m.SoftShrink(0.6), 1.0),
    "HardTanh": (lambda m: m.HardTanh(-0.5, 0.8), 1.0),
    "RReLU": (lambda m: m.RReLU(), 1.0),
    "CAdd": (lambda m: m.CAdd((3, 1)), 1.0),
    "CMul": (lambda m: m.CMul((4,)), 1.0),
    "Scale": (lambda m: m.Scale((3, 4)), 1.0),
    "Mul": (lambda m: m.Mul(), 1.0),
    "Expand": (lambda m: m.Expand((3, 4)), "col"),
    "Max": (lambda m: m.Max(2), 1.0),
    "Max_index": (lambda m: m.Max(1, return_value=False), 1.0),
}


@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math_layers_match_jax(case):
    build, kind = MATH_CASES[case]
    shape = (2, 3, 1) if kind == "col" else (2, 3, 4)
    x = _x(9, shape)
    if kind == "pos":
        x = np.abs(x) + 0.1
    tl, jl = build(tmath), build(jmath)
    tl.name = jl.name = "l"
    tl.ensure_built(shape[1:])
    _randomize(tl, 10)
    index = case == "Max_index"
    want = check_layer(tl, jl, x, grads=not index
                       and case != "BinaryThreshold")
    assert tuple(tl.compute_output_shape(shape[1:])) == \
        tuple(np.shape(want)[1:])
    if index:
        assert tl(torch.from_numpy(x)).dtype == torch.int32


def test_rrelu_training_draws_slopes_in_range():
    layer = tmath.RReLU(0.1, 0.3)
    layer.train()
    layer.seed_dropout(5)
    x = -torch.ones(20000)
    slope = -layer(x)
    assert float(slope.min()) >= 0.1 and float(slope.max()) <= 0.3
    assert abs(float(slope.mean()) - 0.2) < 0.005
    layer.eval()
    np.testing.assert_allclose(to_np(layer(x)), -0.2, rtol=1e-6)


def test_gaussian_sampler():
    """Eval: the mean (as JAX with no rng); training with a seed: mean +
    exp(log_var / 2)·N(0, 1) by its moments."""
    mean, log_var = _x(11, (4000, 3)), np.full((4000, 3), np.log(4.0),
                                               np.float32)
    layer = tmath.GaussianSampler()
    got = layer([torch.from_numpy(mean), torch.from_numpy(log_var)])
    want = jmath.GaussianSampler().call({}, [mean, log_var])
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    layer.train()
    layer.seed_dropout(2)
    z = to_np(layer([torch.from_numpy(mean), torch.from_numpy(log_var)])) \
        - mean
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 2.0) < 0.1
    assert tuple(layer.compute_output_shape([(3,), (3,)])) == (3,)


def test_table_layers_in_a_graph_match_jax():
    """SplitTensor's list output feeds SelectTable nodes and a Dense; the
    graph's output shapes and values against the JAX graph; GetShape."""
    def build(lib, graph, models):
        inp = graph.Input((6, 4), name="in")
        parts = lib.SplitTensor(1, 3, name="split")(inp)
        a = lib.SelectTable(0, name="s0")(parts)
        b = lib.SelectTable(2, name="s2")(parts)
        return models.Model(input=inp, output=[a, b])
    tm, jm = build(tmath, tgraph, tmodels), build(jmath, jgraph, jmodels)
    assert [n.shape for n in tm.output_nodes] == [(2, 4), (2, 4)]
    x = _x(12, (3, 6, 4))
    jp, _ = _graph_params(jm, tm)
    for g, w in zip(tm(torch.from_numpy(x)), jm.call(jp, x)):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    got = tmath.GetShape()(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(got), np.asarray(
        jmath.GetShape().call({}, x)))
    assert got.dtype == torch.int32


# -- embedding -------------------------------------------------------------------

@pytest.fixture
def glove(tmp_path):
    g = np.random.default_rng(13)
    words = ["the", "cat", "sat", "on", "mat", "zebra"]
    path = tmp_path / "glove.6B.5d.txt"
    path.write_text("".join(
        w + " " + " ".join(f"{v:.6f}" for v in g.normal(size=5)) + "\n"
        for w in words), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("given_index", [False, True])
def test_word_embedding_matches_jax(glove, trainable, given_index):
    index = {"cat": 1, "mat": 2, "dog": 3, "the": 5} if given_index \
        else None
    tl = temb.WordEmbedding(glove, word_index=index, trainable=trainable,
                            name="w")
    jl = jemb.WordEmbedding(glove, word_index=index, trainable=trainable,
                            name="w")
    ids = np.array([[1, 2, 3, 0], [5, 4, 0, 2]], np.int32)
    jp = jl.build(jax.random.PRNGKey(0), (4,))
    assert sorted(params_np(tl)) == sorted(jp)
    want = check_layer(tl, jl, ids, params=jp, grads=trainable,
                       x_grad=False)
    assert tuple(tl.compute_output_shape((4,))) == want.shape[1:]
    assert temb.WordEmbedding.get_word_index(glove) == \
        jemb.WordEmbedding.get_word_index(glove)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_matches_jax(combiner):
    tl = temb.SparseEmbedding(9, 4, combiner=combiner, name="s")
    ids = np.array([[1, 4, 0, 0], [0, 0, 0, 0], [8, 8, 2, 1],
                    [-1, 3, 0, 12]], np.int32)
    want = check_layer(tl, jemb.SparseEmbedding(9, 4, combiner=combiner,
                                                name="s"),
                       ids, x_grad=False, tol=dict(LAYER_TOL,
                                                   equal_nan=True))
    assert np.isnan(np.asarray(want)[3]).all()      # id 12 past the table


@pytest.mark.parametrize("bias", [True, False])
def test_sparse_dense_matches_jax(bias):
    tl = temb.SparseDense(10, 3, activation="tanh", bias=bias, name="sd")
    _randomize(tl, 14)
    idx = np.array([[0, 3, -1], [9, 9, 2], [-1, -1, -1]], np.int32)
    vals = _x(15, (3, 3))
    check_layer(tl, jemb.SparseDense(10, 3, activation="tanh", bias=bias,
                                     name="sd"), [idx, vals], x_grad=False)
    assert tuple(tl.compute_output_shape([(3,), (3,)])) == (3,)


# -- mixture of experts -----------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_matches_jax(top_k):
    tl = tmoe.MixtureOfExperts(4, 12, top_k=top_k, input_shape=(5, 8),
                               name="moe")
    _randomize(tl, 16)
    jl = jmoe.MixtureOfExperts(4, 12, top_k=top_k, name="moe")
    x = _x(17, (2, 5, 8))
    check_layer(tl, jl, x)
    p = params_np(tl)
    g_t = tl.gates(torch.from_numpy(x))
    g_j = jl.gates(p, x)
    np.testing.assert_allclose(to_np(g_t), np.asarray(g_j), **LAYER_TOL)
    np.testing.assert_allclose(float(tl.aux_load_balance_loss(g_t).detach()),
                               float(jl.aux_load_balance_loss(g_j)),
                               rtol=1e-6)


def test_moe_gate_ties_break_by_index():
    """An all-zero token ties every expert's probability: lax.top_k keeps
    the lowest indices, and so must the port (two experts, not four)."""
    tl = tmoe.MixtureOfExperts(6, 4, top_k=2, input_shape=(3, 5), name="m")
    jl = jmoe.MixtureOfExperts(6, 4, top_k=2, name="m")
    x = np.zeros((1, 3, 5), np.float32)
    x[0, 1] = _x(18, (5,))
    g_t, g_j = to_np(tl.gates(torch.from_numpy(x))), np.asarray(
        jl.gates(params_np(tl), x))
    np.testing.assert_allclose(g_t, g_j, **LAYER_TOL)
    np.testing.assert_array_equal(g_t[0, 0], [0.5, 0.5, 0, 0, 0, 0])
    assert (g_t > 0).sum(-1).max() == 2


def test_moe_mesh_waits_for_multi_gpu():
    """Expert parallelism comes through a sharding plan, as in JAX (whose
    layer has no ``mesh=``): with the E axis over ``expert`` 4 each rank
    holds one expert, and the ranks' partial outputs (the psum left to
    this test, on a mesh with no world behind it) sum to the JAX
    forward."""
    from analytics_zoo_tpu_torch.common.context import Mesh, P
    from analytics_zoo_tpu_torch.parallel.sharding import ShardingPlan
    from analytics_zoo_tpu_torch.utils.convert import load_jax_params
    with pytest.raises(TypeError, match="mesh"):
        tmoe.MixtureOfExperts(4, 8, mesh=object())
    ref = tmoe.MixtureOfExperts(4, 12, top_k=2, input_shape=(5, 8),
                                name="moe")
    _randomize(ref, 16)
    p = params_np(ref)
    x = _x(17, (2, 5, 8))
    want = np.asarray(jmoe.MixtureOfExperts(4, 12, top_k=2,
                                            name="moe").call(p, x))
    total = 0
    for r in range(4):
        tl = tmoe.MixtureOfExperts(4, 12, top_k=2, input_shape=(5, 8),
                                   name="moe")
        load_jax_params(tl, p)
        ShardingPlan([(r"^experts/", P("expert"))]).shard(
            tl, Mesh(("expert",), (4,), range(4), r))
        assert tuple(tl.W1.shape) == (1, 8, 12)
        total = total + to_np(tl(torch.from_numpy(x)))
    np.testing.assert_allclose(total, want, **LAYER_TOL)


# -- Merge with branch layers ------------------------------------------------------

@pytest.mark.parametrize("mode", ["concat", "sum", "cos"])
def test_merge_branch_layers_match_jax(mode):
    """``Merge(layers, mode)``: the JAX signature, its first positional
    argument the branch layers, each applied to its input."""
    def branches(core):
        return [core.Dense(4, activation="relu", input_shape=(3,),
                           name="ba"),
                core.Dense(4, input_shape=(5,), name="bb")]
    tl = tcore.Merge(branches(tcore), mode, name="mg")
    _randomize(tl, 19)
    jl = jcore.Merge(branches(jcore), mode, name="mg")
    xs = [_x(20, (2, 3)), _x(21, (2, 5))]
    want = check_layer(tl, jl, xs)
    assert tuple(tl.compute_output_shape([(3,), (5,)])) == want.shape[1:]
    assert sorted(params_np(tl)) == ["ba", "bb"]


def test_merge_keeps_its_mode_keyword():
    m = tcore.Merge(mode="mul")
    assert m.mode == "mul" and len(m.branches) == 0
    with pytest.raises(ValueError, match="input_shape"):
        tcore.Merge([tcore.Dense(2)])


# -- autograd --------------------------------------------------------------------

AG_CASES = {
    "unary": lambda ag, x, y: ag.sqrt(ag.square(x) + 1.0) + ag.abs(
        ag.exp(ag.neg(x)) - ag.softplus(y)) + ag.erf(ag.softsign(x)),
    "log_clip_pow": lambda ag, x, y: ag.log(ag.clip(x, 0.1, 2.0))
    * ag.pow(ag.maximum(y, 0.5), 2.0),
    "reductions": lambda ag, x, y: ag.mean(x, axis=1, keep_dims=True)
    + ag.sum(y, axis=-1, keep_dims=True),
    "slices": lambda ag, x, y: ag.slice(x, 1, -3, 2)
    - ag.index_select(y, 1, [2, -1]),
    "index_scalar": lambda ag, x, y: ag.index_select(x, 0, 1) * 2.0,
    "squeeze_expand": lambda ag, x, y: ag.expand(ag.expand_dims(
        ag.squeeze(ag.slice(x, 1, 0, 1), 1), 2), (-1, 3)),
    "stack": lambda ag, x, y: ag.stack([x, y, ag.maximum(x, y)], axis=1),
    "l2": lambda ag, x, y: ag.l2_normalize(x, axis=-1) / (1.0 + y),
    "mm": lambda ag, x, y: ag.mm(x, ag.expand_dims(ag.sum(y, axis=0), 2)),
    "mm_axes": lambda ag, x, y: ag.mm(x, y, axes=[1, 1]),
    "batch_dot": lambda ag, x, y: ag.batch_dot(x, y, axes=(2, 2)),
    "sugar": lambda ag, x, y: (2.0 - x) * y / (x * x + 1.0) - (-y) ** 2,
    "getitem": lambda ag, x, y: x[1:3] + y[1, None],
}


def _ag_graph(ag, graph, models, case):
    x, y = graph.Input((3, 4), name="x"), graph.Input((3, 4), name="y")
    return models.Model(input=[x, y], output=AG_CASES[case](ag, x, y))


@pytest.mark.parametrize("case", sorted(AG_CASES))
def test_autograd_expressions_match_jax(case):
    tm = _ag_graph(tag, tgraph, tmodels, case)
    jm = _ag_graph(jag, jgraph, jmodels, case)
    xs = [_x(22, (2, 3, 4)), _x(23, (2, 3, 4))]
    jp, _ = _graph_params(jm, tm)
    want = jm.call(jp, xs)
    ts = [torch.from_numpy(v).requires_grad_(True) for v in xs]
    got = tm(ts)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LAYER_TOL)
    assert tuple(tm.output_nodes[0].shape) == np.shape(want)[1:]
    r = _x(24, np.shape(want))
    jg = jax.grad(lambda v: jnp.sum(jm.call(jp, v) * r))(xs)
    (got * torch.from_numpy(r)).sum().backward()
    for t, w in zip(ts, jg):
        grad = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(to_np(grad), np.asarray(w), **LAYER_TOL)


def test_autograd_parameter_and_constant_match_jax():
    def build(ag, graph, models):
        x = graph.Input((4,), name="x")
        w = ag.Parameter((4,), name="w")(x)
        c = ag.Constant(np.arange(4, dtype=np.float32), name="c")(x)
        return models.Model(input=x, output=x * w + c)
    tm, jm = build(tag, tgraph, tmodels), build(jag, jgraph, jmodels)
    _randomize(tm, 25)
    jp, _ = _graph_params(jm, tm)
    x = _x(26, (3, 4))
    np.testing.assert_allclose(to_np(tm(torch.from_numpy(x))),
                               np.asarray(jm.call(jp, x)), **LAYER_TOL)
    init = np.array([1.0, 2.0], np.float32)
    p = tag.Parameter((2,), init_weight=init, name="p0")
    np.testing.assert_array_equal(to_np(p.value), init)


def test_custom_loss_matches_jax():
    def builder(ag):
        return lambda yt, yp: ag.mean(ag.abs(yt - yp) * 2.0, axis=1)
    t_loss = tag.custom_loss(builder(tag), (3, 2))
    j_loss = jag.custom_loss(builder(jag), (3, 2))
    yp, yt = _x(27, (5, 3, 2)), _x(28, (5, 3, 2))
    np.testing.assert_allclose(
        to_np(t_loss(torch.from_numpy(yp), torch.from_numpy(yt))),
        np.asarray(j_loss(yp, yt)), **LAYER_TOL)


def test_keras2_and_autograd_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import analytics_zoo_tpu_torch.nn.keras2 as k2\n"
            "import analytics_zoo_tpu_torch.nn.autograd as ag\n"
            "from analytics_zoo_tpu_torch.nn.layers import "
            "MixtureOfExperts, Convolution3D, WordEmbedding\n"
            "import json; print(json.dumps([hasattr(k2, 'DepthwiseConv2D'),"
            " hasattr(ag, 'custom_loss')]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True]
