"""PyTorch port: the multi-GPU slice's host logic against the JAX package,
in one process on the CPU.

- ``leaf_paths`` of the port's ``export_params`` tree against the JAX
  param tree's, and ``megatron_plan`` / ``ShardingPlan._fit`` specs path
  by path (GPT-2 tiny, a MoE model), the divisibility warning once;
- ``serving_mode_for`` / ``tensor_parallel_applicable`` / ``serving_plan``
  on the same trees;
- the context: mesh shapes with ``-1``, ``batch_sharding_for`` rule for
  rule, ``process_rows``, collectives that communicate nothing without a
  world;
- the parallel forms' slicing on a mesh of 4 ranks without a world (no
  collective runs: each rank's part is computed and the test does the
  sums a ``psum`` would): the fused ``qkv`` split by heads, expert
  parallelism's partial outputs summing to the JAX forward, a leaf no
  layer can compute on raising with its name;
- ``PipelinedTransformer(pipelined=False)`` against the JAX layer;
- a gloo world of one: ``Estimator.fit`` launches its gradient all-reduce
  and gives the losses of the fit with no world, bit for bit.

The real multi-process cases are ``test_torch_port_parallel_world.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import ZooConf as JaxConf
from analytics_zoo_tpu.common.context import ZooContext as JaxContext
from analytics_zoo_tpu.nn.layers import attention as jatt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers.moe import MixtureOfExperts as JaxMoE
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.parallel import sharding as jsh
from analytics_zoo_tpu.parallel.pipeline_model import \
    PipelinedTransformer as JaxPT
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.context import (Mesh, P, ZooConf,
                                                    ZooContext)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers import attention as tatt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers.moe import MixtureOfExperts
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.parallel import comm
from analytics_zoo_tpu_torch.parallel import sharding as tsh
from analytics_zoo_tpu_torch.parallel.pipeline_model import \
    PipelinedTransformer
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gpt(m, core, V=50, H=32, NB=2, NH=4, T=16):
    return [m.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                               n_head=NH, seq_len=T, input_shape=(T,),
                               name="tl"),
            core.Dense(V, activation="softmax", name="head")]


@pytest.fixture(scope="module")
def gpt():
    jm = JaxSeq(_gpt(jatt, jcore))
    params = _np(jm.init_weights(jax.random.PRNGKey(0)))
    tm = Sequential(_gpt(tatt, tcore))
    load_jax_params(tm, params)
    return jm, params, tm


def _moe_pair():
    jl = JaxMoE(4, 16, top_k=2, name="moe")
    params = _np(jl.build(jax.random.PRNGKey(0), (6, 8)))
    tl = MixtureOfExperts(4, 16, top_k=2, input_shape=(6, 8), name="moe")
    load_jax_params(tl, params)
    return jl, params, tl


def _fake_mesh(axes, shape, rank):
    """A mesh of ranks with no world behind it: shapes and indices only,
    every collective the identity."""
    return Mesh(axes, shape, range(int(np.prod(shape))), rank)


# -- plans -------------------------------------------------------------------------

def test_leaf_paths_match_jax(gpt):
    _, params, tm = gpt
    assert [p for p, _ in tsh.leaf_paths(tm)] == \
        [p for p, _ in jsh.leaf_paths(params)]
    jl, mparams, tl = _moe_pair()
    assert [p for p, _ in tsh.leaf_paths(tl)] == \
        [p for p, _ in jsh.leaf_paths(mparams)]


@pytest.mark.parametrize("plan", ["megatron", "experts", "replicated"])
def test_plan_specs_match_jax_path_by_path(gpt, plan):
    """``spec_for`` and the fitted spec on a model 4 / expert 4 mesh (JAX on
    4 of the conftest's devices): equal for every leaf."""
    _, params, tm = gpt
    jl, mparams, tl = _moe_pair()
    make = {"megatron": lambda m: m.megatron_plan(),
            "experts": lambda m: m.ShardingPlan(
                [(r"^experts/", (m.P if m is tsh else jax.sharding
                                 .PartitionSpec)("expert"))]),
            "replicated": lambda m: m.replicated_plan()}[plan]
    jplan, tplan = make(jsh), make(tsh)
    for axis in ("model", "expert"):
        jmesh = JaxMesh(np.array(jax.devices()[:4]), (axis,))
        tmesh = _fake_mesh((axis,), (4,), 0)
        for tree, ttree in ((params, tm), (mparams, tl)):
            tp = dict(tsh.leaf_paths(ttree))
            for path, leaf in jsh.leaf_paths(tree):
                js = jplan.spec_for(path, leaf)
                ts = tplan.spec_for(path, tp[path])
                assert tuple(ts) == tuple(js), path
                assert tuple(tplan._fit(ts, tmesh, leaf.shape, path)) == \
                    tuple(jplan._fit(js, jmesh, leaf.shape, path)), path


def test_fit_warns_once_for_a_dimension_that_does_not_divide(caplog):
    """GPT-2 small's vocabulary (50257) over model 4 replicates, with one
    warning however often the leaf is placed."""
    plan = tsh.megatron_plan()
    mesh = _fake_mesh(("model",), (4,), 0)
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.parallel.sharding"):
        for _ in range(3):
            spec = plan._fit(plan.spec_for("tl/wte"), mesh, (50257, 768),
                             "tl/wte")
    assert tuple(spec) == ()
    assert sum("not divisible" in r.message for r in caplog.records) == 1
    assert tuple(plan._fit(P("model", None), mesh, (64, 8), "x")) == \
        ("model",)
    assert tuple(plan._fit(P(None, "seq"), mesh, (8, 8), "x")) == ()


@pytest.mark.parametrize("threshold", [1, 10 ** 9])
def test_serving_mode_and_plan_match_jax(gpt, threshold):
    _, params, tm = gpt
    jl, mparams, tl = _moe_pair()
    for tree, ttree in ((params, tm), (mparams, tl)):
        assert tsh.serving_mode_for(ttree, threshold) == \
            jsh.serving_mode_for(tree, threshold)
        assert tsh.tensor_parallel_applicable(ttree) == \
            jsh.tensor_parallel_applicable(tree)
        assert tsh._param_count(ttree) == jsh._param_count(tree)
        jmesh = jsh.serving_mesh(4, mode="tensor")
        tmesh = _fake_mesh(("data", "model"), (1, 4), 0)
        assert [r[0] for r in tsh.serving_plan(ttree, tmesh,
                                                threshold).rules] == \
            [r[0] for r in jsh.serving_plan(tree, jmesh, threshold).rules]
    with pytest.raises(ValueError, match="needs 4 processes"):
        tsh.serving_mesh(4)


def test_shard_of_a_tree_is_each_rank_slice():
    """A plain tree: each rank's contiguous slice (``global_put``), the
    JAX placement's addressable shard of the same device."""
    tree = {"fc": {"W": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
                   "b": np.arange(16, dtype=np.float32)}}
    plan = tsh.ShardingPlan([(r".*W$", P(None, "model"))])
    jmesh = JaxMesh(np.array(jax.devices()[:4]), ("model",))
    jplaced = jsh.ShardingPlan([(r".*W$", jax.sharding.PartitionSpec(
        None, "model"))]).shard(tree, jmesh)
    shards = {s.device: np.asarray(s.data)
              for s in jplaced["fc"]["W"].addressable_shards}
    for r in range(4):
        local = plan.shard(tree, _fake_mesh(("model",), (4,), r))
        np.testing.assert_array_equal(local["fc/W"].numpy(),
                                      shards[jax.devices()[r]])
        np.testing.assert_array_equal(local["fc/b"].numpy(),
                                      tree["fc"]["b"])


# -- the context -------------------------------------------------------------------

def test_context_mesh_without_a_world():
    ctx = ZooContext(ZooConf(device="cpu", mesh_axes=("data", "model"),
                             mesh_shape=(-1, 1)))
    assert ctx.mesh.shape == {"data": 1, "model": 1}
    assert (ctx.num_devices, ctx.process_count, ctx.process_index,
            ctx.is_multi_host, ctx.data_parallel_size) == (1, 1, 0, False, 1)
    assert ctx.mesh.group("data") is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ZooContext(ZooConf(device="cpu", mesh_axes=("data",),
                           mesh_shape=(2,)))
    x = torch.arange(6.0)
    for fn in (lambda t: comm.psum(t, "data", ctx.mesh),
               lambda t: comm.copy_to(t, "data", ctx.mesh),
               lambda t: comm.ppermute(t, "data", 1, ctx.mesh),
               lambda t: comm.all_gather(t, "data", 0, ctx.mesh)):
        assert fn(x) is x
    assert comm.all_gather_object({"a": 1}, mesh=ctx.mesh) == [{"a": 1}]


@pytest.mark.parametrize("shape,token_len", [
    ((8, 16), 16), ((8, 16, 32), 16), ((8, 4), 16), ((8, 16), None),
    ((8, 15), 15), ((8,), 16), ((8, 1), 1)])
def test_batch_sharding_for_matches_jax(shape, token_len):
    jctx = JaxContext(JaxConf(mesh_axes=("data", "seq"), mesh_shape=(2, 2)),
                      devices=jax.devices()[:4])
    tctx_ = ZooContext(ZooConf(device="cpu"))
    tctx_.mesh = _fake_mesh(("data", "seq"), (2, 2), 0)
    want = tuple(jctx.batch_sharding_for(shape, token_len).spec)
    got = tuple(tctx_.batch_sharding_for(shape, token_len))
    assert got[:len(want)] == want and not any(got[len(want):])


def test_process_rows_give_the_one_process_batches():
    ctx = ZooContext(ZooConf(device="cpu"))
    for n, bs, dp in ((32, 8, 2), (30, 8, 2), (32, 8, 4)):
        rows = []
        for d in range(dp):
            ctx.mesh = _fake_mesh(("data",), (dp,), d)
            rows.append(tsh.process_rows(n, bs, ctx))
        fb = bs // dp
        glued = np.concatenate([np.concatenate([r[k * fb:(k + 1) * fb]
                                                for r in rows])
                                for k in range(-(-n // bs))])
        np.testing.assert_array_equal(glued, np.arange(n))


# -- parallel forms on a mesh without a world -------------------------------------

def test_megatron_form_slices_heads_and_columns(gpt):
    """Rank r of model 4 holds heads 3r..3r+2's q, k and v columns of the
    fused qkv, its FFN columns, and the vocabulary rows 16r..16r+15
    (V = 64 divides); proj/W stays whole, as the JAX plan leaves it."""
    jm = JaxSeq(_gpt(jatt, jcore, V=64, NH=4))
    params = _np(jm.init_weights(jax.random.PRNGKey(1)))
    for r in range(4):
        tm = Sequential(_gpt(tatt, tcore, V=64, NH=4))
        load_jax_params(tm, params)
        mesh = _fake_mesh(("model",), (4,), r)
        tsh.megatron_plan().shard(tm, mesh)
        blk = tm.layers_list[0].blocks[0]
        W = params["tl"]["tl_block0"]["attn"]["qkv"]["W"]
        hd = 8
        cols = np.concatenate([np.arange(g * 32 + r * hd, g * 32 + (r + 1)
                                         * hd) for g in range(3)])
        np.testing.assert_array_equal(blk.attn.qkv.W.detach().numpy(),
                                      W[:, cols])
        assert tuple(blk.ffn.fc.W.shape) == (32, 32)
        assert tuple(blk.ffn.proj.W.shape) == (128, 32)
        np.testing.assert_array_equal(
            tm.layers_list[0].wte.detach().numpy(),
            params["tl"]["wte"][16 * r:16 * (r + 1)])
        assert tm.layers_list[0].wte._zoo_shard_axes == ("model",)
        lt = tsh.local_tree(tm, params, mesh)
        for path, leaf in tsh.leaf_paths(tm):
            np.testing.assert_array_equal(leaf.numpy(), lt[path].numpy())


def test_moe_expert_parallel_partials_sum_to_jax():
    """Expert 2 without a world: each rank's partial output (its experts'
    gate-weighted sum, the psum left to this test) sums to the JAX
    forward."""
    jl, params, _ = _moe_pair()
    x = np.asarray(np.random.default_rng(1).normal(size=(8, 6, 8)),
                   np.float32)
    ref = np.asarray(jl.call(params, jnp.asarray(x)))
    total = 0
    for r in range(2):
        tl = MixtureOfExperts(4, 16, top_k=2, input_shape=(6, 8),
                              name="moe")
        load_jax_params(tl, params)
        tsh.ShardingPlan([(r"^experts/", P("expert"))]).shard(
            tl, _fake_mesh(("expert",), (2,), r))
        assert tuple(tl.W1.shape) == (2, 8, 16)
        total = total + tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(total, ref, rtol=1e-4, atol=1e-5)


def test_a_leaf_no_layer_can_split_raises_naming_it():
    bert = Sequential([tatt.BERT(vocab=64, hidden_size=16, n_block=1,
                                 n_head=2, max_position_len=8,
                                 intermediate_size=32, input_shape=(8,),
                                 name="bert")])
    with pytest.raises(NotImplementedError, match="bert/word"):
        tsh.megatron_plan().shard(bert, _fake_mesh(("model",), (4,), 0))
    odd = Sequential(_gpt(tatt, tcore, V=64, NH=2))
    with pytest.raises(ValueError, match="2 heads do not split"):
        tsh.megatron_plan().shard(odd, _fake_mesh(("model",), (4,), 0))
    dense = Sequential([tcore.Dense(8, input_shape=(4,), name="d")])
    with pytest.raises(NotImplementedError, match="d"):
        tsh.ShardingPlan([(r".*W$", P("model", "data"))]).shard(
            dense, _fake_mesh(("model", "data"), (2, 2), 0))


def test_pipelined_transformer_sequential_matches_jax():
    jl = JaxPT(vocab=50, hidden_size=32, n_stages=2, n_head=2, seq_len=8,
               n_micro=4, pipelined=False, name="pt")
    params = _np(jl.build(jax.random.PRNGKey(0), (8,)))
    tl = PipelinedTransformer(vocab=50, hidden_size=32, n_stages=2,
                              n_head=2, seq_len=8, n_micro=4,
                              pipelined=False, name="pt")
    load_jax_params(tl, params)
    assert [p for p, _ in tsh.leaf_paths(tl)] == \
        [p for p, _ in jsh.leaf_paths(params)]
    x = np.random.default_rng(3).integers(0, 50, (4, 8))
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl.call(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pipe axis"):
        PipelinedTransformer(vocab=50, hidden_size=32, n_stages=2,
                             n_head=2, seq_len=8, name="pp2",
                             mesh=_fake_mesh(("data",), (1,), 0))(
            torch.from_numpy(x))


# -- a world of one ----------------------------------------------------------------

def _lm_fit(ctx, tm, x, y):
    est = Estimator(tm, optimizer=topt.Adam(lr=1e-3), clip_norm=0.5,
                    loss="sparse_categorical_crossentropy", ctx=ctx,
                    registry=MetricsRegistry())
    losses = []
    est._listeners.append(lambda s, l: losses.append(float(l)))
    est.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=False)
    return losses, [p.detach().clone() for p in est.params], est


def test_world_of_one_fit_launches_its_reduce_and_matches(gpt, tmp_path,
                                                          monkeypatch):
    """A gloo world of one: the data axis holds the world's group, the fit
    all-reduces its weights and gradients there, and its losses and
    weights are the no-world fit's bit for bit."""
    _, params, _ = gpt
    g = np.random.default_rng(2)
    s = g.integers(0, 50, (16, 17))
    x, y = s[:, :-1].astype(np.int32), s[:, 1:].astype(np.int32)
    ref = Sequential(_gpt(tatt, tcore))
    load_jax_params(ref, params)
    want = _lm_fit(ZooContext(ZooConf(device="cpu", seed=42)), ref, x, y)
    calls = []
    orig = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ctx = ZooContext(ZooConf(device="cpu", seed=42))
        assert ctx.mesh.group("data") is dist.group.WORLD
        tm = Sequential(_gpt(tatt, tcore))
        load_jax_params(tm, params)
        got = _lm_fit(ctx, tm, x, y)
    finally:
        dist.destroy_process_group()
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert len(calls) == 2 * 2                 # 2 steps: weights + grads
    assert got[2].fit_summary()["route"] == "eager"
    assert tctx._world() == (0, 1)
