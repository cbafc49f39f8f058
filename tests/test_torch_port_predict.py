"""PyTorch port: the predict plane against the JAX package, on the CPU.

One JAX param tree (``init`` from a fixed PRNG key) is loaded into the
port's layers with ``utils/convert.load_jax_params``; the same numpy inputs
then go through both packages: the layer IR (``Dense``, pooling,
``LayerNorm``, ``TransformerBlock``, ``TransformerLayer``, ``BERT``,
``Sequential``), ``InferenceModel`` (``do_predict`` with odd batch sizes
and chunking, ``dispatch``, the per-row ``scales`` path) and the serving
engine's predict plane (same records, top-N results).

Tolerances: atol 1e-5 on activations and probabilities — both sides run
the same f32 math, and XLA's and PyTorch's CPU kernels sum in different
orders (matmuls, LayerNorm and softmax reductions).  Exact where the math
is: parameter names, shapes, counts, top-N class lists.  On the CPU the
attention takes a plain path on both sides: the JAX package its einsum
path (it picks its kernel only on a TPU), the port the flash kernel's
plain version for unmasked calls and its einsum path for masked ones.
"""

import base64
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import aot as jaot
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn import activations as jact
from analytics_zoo_tpu.nn.layers import attention as jatt
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving.queues import InProcQueue as JaxQueue
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.inference import aot as taot
from analytics_zoo_tpu_torch.inference.inference_model import (
    InferenceModel, _bucket)
from analytics_zoo_tpu_torch.nn import activations as tact
from analytics_zoo_tpu_torch.nn.layers import attention as tatt
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import pooling as tpool
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.queues import InProcQueue
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

ATOL = 1e-5
V, H, T, NB, NH = 48, 32, 16, 2, 2


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy the tolerances here assume.
    Its policy is process-global, and a test that runs a benchmark
    in-process in the same worker may leave it at bf16."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(layer, shape, seed=0):
    params, state = layer.init(jax.random.PRNGKey(seed), shape)
    return _np(params), state


def _run(layer, x):
    with torch.inference_mode():
        xs = [torch.from_numpy(np.asarray(a)) for a in x] \
            if isinstance(x, list) else torch.from_numpy(np.asarray(x))
        return layer(xs).numpy()


def _ids(seed, n, t=T, vocab=V):
    return np.random.default_rng(seed).integers(0, vocab, (n, t)).astype(
        np.float32)


# -- layers -------------------------------------------------------------------

def test_auto_names_follow_the_jax_scheme():
    d = tcore.Dense(3, input_shape=(4,))
    i = int(d.name.rsplit("_", 1)[1])
    assert d.name == f"dense_{i}"
    assert tcore.Dense(3, input_shape=(4,)).name == f"dense_{i + 1}"
    blk = tatt.TransformerBlock(H, NH, name="enc")
    assert [blk.attn.name, blk.ffn.name, blk.ln1.name, blk.ln2.name] == \
        ["enc_attn", "enc_ffn", "enc_ln1", "enc_ln2"]
    tl = tatt.TransformerLayer(V, H, NB, NH, T, name="gpt")
    assert [b.name for b in tl.blocks] == ["gpt_block0", "gpt_block1"]


@pytest.mark.parametrize("act", [None, "relu", "tanh", "softmax", "gelu",
                                 "hard_sigmoid", "log_softmax", "elu"])
def test_dense_matches_jax(act):
    jd = jcore.Dense(7, activation=act, name="d")
    params, _ = _init(jd, (5,))
    td = tcore.Dense(7, activation=act, input_shape=(5,), name="d")
    load_jax_params(td, params)
    x = np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(_run(td, x),
                               np.asarray(jd.call(params, x)), atol=ATOL)
    assert td.param_count() == 5 * 7 + 7
    assert td.compute_output_shape((4, 5)) == (4, 7)


@pytest.mark.parametrize("layer", ["dense", "linear"])
def test_bf16_compute_policy_accumulates_in_f32_like_jax(layer):
    """Under a bf16 compute policy the operands are rounded to bf16 but the
    product is summed and returned in f32 (JAX's preferred_element_type):
    atol 1e-5 is f32 summation order, far below the ~4e-3 that rounding
    the product to bf16 would cost at |y| ~ 1."""
    x = np.random.default_rng(5).normal(size=(4, 24)).astype(np.float32)
    jd = jcore.Dense(9, name="d")
    params, _ = _init(jd, (24,))
    params["b"] = params["b"] + 0.5
    td = tcore.Dense(9, input_shape=(24,), name="d")
    load_jax_params(td, params)
    saved = dict(tdtypes._policy)
    jdtypes.mixed_bf16()
    tdtypes.mixed_bf16()
    try:
        if layer == "dense":
            want, got = jd.call(params, x), _run(td, x)
        else:
            want = jatt._linear(params, x)
            with torch.inference_mode():
                got = tatt._linear(td, torch.from_numpy(x)).numpy()
    finally:
        jdtypes.set_policy(None)
        tdtypes._policy.update(saved)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["relu", "relu6", "tanh", "sigmoid",
                                  "hard_sigmoid", "softmax", "log_softmax",
                                  "softplus", "softsign", "elu", "selu",
                                  "gelu", "swish", "silu", "exp", "linear"])
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 24, dtype=np.float32).reshape(2, 12)
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jact.get(name)(x)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cls,ordering", [("GlobalAveragePooling1D", "tf"),
                                          ("GlobalAveragePooling1D", "th"),
                                          ("GlobalMaxPooling1D", "tf"),
                                          ("GlobalMaxPooling1D", "th")])
def test_global_pooling_matches_jax(cls, ordering):
    x = np.random.default_rng(2).normal(size=(3, 6, 5)).astype(np.float32)
    jp = getattr(jpool, cls)(dim_ordering=ordering)
    tp = getattr(tpool, cls)(dim_ordering=ordering)
    np.testing.assert_allclose(_run(tp, x), np.asarray(jp.call({}, x)),
                               atol=1e-6)
    assert tp.compute_output_shape((6, 5)) == \
        ((5,) if ordering == "tf" else (6,))


def test_layernorm_matches_jax():
    jl = jatt.LayerNorm(name="ln")
    params, _ = _init(jl, (H,))
    params = {"gamma": params["gamma"] * 1.5, "beta": params["beta"] + 0.25}
    tl = tatt.LayerNorm(input_shape=(H,), name="ln")
    load_jax_params(tl, params)
    x = np.random.default_rng(3).normal(size=(2, 5, H)).astype(np.float32)
    np.testing.assert_allclose(_run(tl, x), np.asarray(jl.call(params, x)),
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_matches_jax(causal):
    jb = jatt.TransformerBlock(H, NH, causal=causal, name="blk")
    params, _ = _init(jb, (T, H))
    tb = tatt.TransformerBlock(H, NH, causal=causal, name="blk")
    load_jax_params(tb, params)
    x = np.random.default_rng(4).normal(size=(3, T, H)).astype(np.float32)
    np.testing.assert_allclose(_run(tb, x), np.asarray(jb.call(params, x)),
                               atol=ATOL)


@pytest.mark.parametrize("bidirectional,all_blocks", [(False, False),
                                                      (True, False),
                                                      (False, True)])
def test_transformer_layer_matches_jax(bidirectional, all_blocks):
    kw = dict(vocab=V, hidden_size=H, n_block=NB, n_head=NH, seq_len=T,
              bidirectional=bidirectional, output_all_block=all_blocks,
              name="gpt")
    jt = jatt.TransformerLayer(**kw)
    params, _ = _init(jt, (T,))
    tt = tatt.TransformerLayer(**kw)
    load_jax_params(tt, params)
    ids = _ids(5, 3)
    want = np.asarray(jt.call(params, ids))
    np.testing.assert_allclose(_run(tt, ids), want, atol=ATOL)
    # a trailing unit axis and a shorter sequence are both accepted
    np.testing.assert_allclose(
        _run(tt, ids[:, :9, None]),
        np.asarray(jt.call(params, ids[:, :9, None])), atol=ATOL)
    assert tt.compute_output_shape((T,)) == \
        ((NB, T, H) if all_blocks else (T, H))
    assert tt.param_count() == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


def test_transformer_layer_out_of_range_ids_follow_jnp_take():
    jt = jatt.TransformerLayer(V, H, NB, NH, T, name="gpt")
    params, _ = _init(jt, (T,))
    tt = tatt.TransformerLayer(V, H, NB, NH, T, name="gpt")
    load_jax_params(tt, params)
    ids = _ids(6, 2)
    ids[0, 3] = -2          # wraps
    ids[1, 5] = V + 4       # NaN row
    got, want = _run(tt, ids), np.asarray(jt.call(params, ids))
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()


def test_bert_with_mask_matches_jax():
    kw = dict(vocab=V, hidden_size=H, n_block=NB, n_head=NH,
              max_position_len=T, intermediate_size=48, name="bert")
    jb = jatt.BERT(**kw)
    params, _ = _init(jb, [(T,), (T,), (T,)])
    tb = tatt.BERT(**kw)
    load_jax_params(tb, params)
    g = np.random.default_rng(7)
    ids = _ids(7, 3)
    types = g.integers(0, 2, (3, T)).astype(np.float32)
    mask = np.ones((3, T), np.float32)
    mask[0, 10:] = 0
    mask[2, 4:] = 0
    x = [ids, types, mask]
    want = np.asarray(jb.call(params, x, training=False))
    got = _run(tb, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.inference_mode():
        pooled = tb.pooled(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(pooled, np.asarray(jb.pooled(params, want)),
                               atol=ATOL)


def _pair(head_act="softmax", seed=0):
    """The slice's model at a tiny width, in both packages, same weights."""
    def layers(m):
        return [m.TransformerLayer(vocab=V, hidden_size=H, n_block=NB,
                                   n_head=NH, seq_len=T, input_shape=(T,),
                                   name="tl"),
                (jpool if m is jatt else tpool).GlobalAveragePooling1D(
                    name="gap"),
                (jcore if m is jatt else tcore).Dense(
                    V, activation=head_act, name="head")]
    jm = JaxSeq(layers(jatt))
    params, state = _init(jm, (T,), seed)
    tm = Sequential(layers(tatt))
    load_jax_params(tm, params)
    return jm, params, state, tm


def test_sequential_matches_jax():
    jm, params, state, tm = _pair()
    ids = _ids(8, 5)
    want = np.asarray(jm.apply(params, state, ids)[0])
    np.testing.assert_allclose(_run(tm, ids), want, atol=ATOL)
    assert tm.compute_output_shape((T,)) == (V,)
    tree = export_params(tm)
    assert sorted(tree) == sorted(params)
    assert sorted(tree["tl"]) == sorted(params["tl"])


def test_sequential_needs_a_declared_first_shape_and_unique_names():
    with pytest.raises(ValueError, match="input_shape"):
        Sequential([tcore.Dense(3)])
    with pytest.raises(ValueError, match="duplicate"):
        Sequential([tcore.Dense(3, input_shape=(4,), name="x"),
                    tcore.Dense(3, name="x")])


def test_load_jax_params_matches_by_name_not_order():
    """JAX flattens dicts in sorted key order — ``dense_10`` before
    ``dense_9`` — so loading must go by name."""
    def model(m):
        return [m.Dense(6, input_shape=(4,), name="dense_9"),
                m.Dense(3, name="dense_10")]
    jm = JaxSeq(model(jcore))
    params, state = _init(jm, (4,))
    assert list(jax.tree_util.tree_flatten_with_path(params)[0][0][0])[
        0].key == "dense_10"
    tm = Sequential(model(tcore))
    load_jax_params(tm, params)
    x = np.random.default_rng(9).normal(size=(2, 4)).astype(np.float32)
    np.testing.assert_allclose(_run(tm, x),
                               np.asarray(jm.apply(params, state, x)[0]),
                               atol=ATOL)
    missing = {"dense_9": params["dense_9"]}
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(tm, missing)
    extra = dict(params, dense_11={"W": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_params(tm, extra)
    bad = {"dense_9": params["dense_9"],
           "dense_10": {"W": np.zeros((5, 3), np.float32),
                        "b": params["dense_10"]["b"]}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, bad)


# -- InferenceModel -------------------------------------------------------------

def test_inference_model_constructor_matches_jax():
    """Positional arguments mean the same thing in both packages:
    (supported_concurrent_num, max_batch)."""
    for args in ((), (4,), (3, 64), (1, 100)):
        j = JaxIM(*args)
        t = InferenceModel(*args, device="cpu")
        assert (t.concurrent_num, t.max_batch) == \
            (j.concurrent_num, j.max_batch)
    assert InferenceModel(device="cpu").concurrent_num == 2


def test_do_load_model_loads_bn_state_like_jax():
    """``do_load_model(model, params, state)`` in both packages: a Dense →
    BatchNormalization model whose params and moving statistics (from
    numpy, far from BN's defaults) are loaded through the call, then
    ``do_predict`` in eval mode agrees within the layers' 1e-5.  Without
    the state the port's output would use mean 0, var 1."""
    def layers(m):
        return [m.Dense(5, input_shape=(6,), name="fc"),
                m.BatchNormalization(name="bn")]
    jm = JaxSeq(layers(jcore))
    _init(jm, (6,))
    g = np.random.default_rng(7)
    params = {"fc": {"W": g.normal(size=(6, 5)).astype(np.float32),
                     "b": g.normal(size=5).astype(np.float32)},
              "bn": {"gamma": g.uniform(0.5, 2, 5).astype(np.float32),
                     "beta": g.normal(size=5).astype(np.float32)}}
    state = {"fc": {},
             "bn": {"mean": g.normal(0, 2, 5).astype(np.float32),
                    "var": g.uniform(0.2, 4, 5).astype(np.float32)}}
    x = g.normal(size=(9, 6)).astype(np.float32)
    want = JaxIM(2, 8).do_load_model(jm, params, state).do_predict(x)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(
        Sequential(layers(tcore)), params, state)
    got = tim.do_predict(x)
    assert got.shape == want.shape == (9, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)
    bare = InferenceModel(2, 8, device="cpu").do_load_model(
        Sequential(layers(tcore)), params).do_predict(x)
    assert np.abs(bare - want).max() > 100 * ATOL


@pytest.mark.parametrize("n,max_batch,bucket", [(1, 8, 1), (3, 8, 4),
                                                (5, 8, 8), (9, 8, 8),
                                                (300, 1024, 512)])
def test_bucket_ladder(n, max_batch, bucket):
    from analytics_zoo_tpu.inference.inference_model import _bucket as jb
    assert _bucket(n, max_batch) == jb(n, max_batch) == bucket


@pytest.fixture(scope="module")
def models():
    jm, params, state, tm = _pair()
    jim = JaxIM(2, 8).do_load_model(jm, params, state)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
    return jim, tim


@pytest.mark.parametrize("n,batch_size", [(1, None), (3, None), (7, None),
                                          (13, None), (11, 3)])
def test_do_predict_matches_jax(models, n, batch_size):
    jim, tim = models
    ids = _ids(10 + n, n)
    want = jim.do_predict(ids, batch_size=batch_size)
    got = tim.do_predict(ids, batch_size=batch_size)
    assert got.shape == want.shape == (n, V)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [2, 5, 12])
def test_dispatch_matches_jax(models, n):
    jim, tim = models
    ids = _ids(20 + n, n)
    np.testing.assert_allclose(tim.dispatch(ids).result(),
                               jim.dispatch(ids).result(), atol=ATOL)


def test_scales_path_matches_jax():
    """int8 rows with per-row scales are dequantized on the device side of
    the call; a float model over (B, F) inputs."""
    def model(m):
        return [m.Dense(8, activation="relu", input_shape=(6,), name="a"),
                m.Dense(4, activation="softmax", name="b")]
    jm = JaxSeq(model(jcore))
    params, state = _init(jm, (6,))
    tm = Sequential(model(tcore))
    load_jax_params(tm, params)
    jim = JaxIM(2, 8).do_load_model(jm, params, state)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
    g = np.random.default_rng(11)
    q = g.integers(-127, 128, (5, 6)).astype(np.int8)
    sc = g.uniform(0.01, 0.1, 5).astype(np.float32)
    np.testing.assert_allclose(tim.do_predict(q, scales=sc),
                               jim.do_predict(q, scales=sc), atol=ATOL)
    np.testing.assert_allclose(tim.dispatch(q, scales=sc).result(),
                               jim.dispatch(q, scales=sc).result(),
                               atol=ATOL)
    with pytest.raises(ValueError):
        tim.do_predict([q, q], scales=sc)


def test_multi_input_predict_matches_jax():
    kw = dict(vocab=V, hidden_size=H, n_block=1, n_head=NH,
              max_position_len=T, intermediate_size=48, name="bert",
              input_shape=[(T,), (T,)])
    jm = JaxSeq([jatt.BERT(**kw)])
    params, state = _init(jm, [(T,), (T,)])
    tm = Sequential([tatt.BERT(**kw)])
    load_jax_params(tm, params)
    ids = _ids(12, 3)
    types = np.random.default_rng(12).integers(0, 2, (3, T)).astype(
        np.float32)
    jim = JaxIM(2, 4).do_load_model(jm, params, state)
    tim = InferenceModel(2, 4, device="cpu").do_load_model(tm)
    np.testing.assert_allclose(tim.do_predict([ids, types]),
                               jim.do_predict([ids, types]), atol=ATOL)


def test_unported_inference_model_entries_raise():
    tim = InferenceModel(device="cpu")
    for name in ("do_load", "do_load_store", "do_load_tensorflow",
                 "do_load_onnx", "do_load_pytorch", "shard"):
        with pytest.raises(NotImplementedError):
            getattr(tim, name)("x")
    with pytest.raises(RuntimeError, match="load a model"):
        tim.do_predict(np.zeros((1, 4), np.float32))


# -- ahead-of-time warm-up ---------------------------------------------------------

@pytest.mark.parametrize("max_batch,cap", [(8, None), (5, 8), (8, 4),
                                           (1, None), (100, 64)])
def test_bucket_ladder_matches_jax(max_batch, cap):
    assert taot.bucket_ladder(max_batch, model_cap=cap) == \
        jaot.bucket_ladder(max_batch, model_cap=cap)


@pytest.mark.parametrize("max_batch,spec,bits", [
    (8, True, None), (8, {"max_batch": 5}, None),
    (16, {"scales": "off"}, None),
    (4, {"scales": "both", "scale_dtypes": ["|i1", "|u1"], "max_batch": 3},
     None),
    (8, {"shape": [T], "dtype": "<f4", "scales": "on"}, None),
    (8, {"scales": "off"}, 4)])
def test_warmup_manifest_matches_jax(max_batch, spec, bits):
    jm, params, state, tm = _pair()
    jim = JaxIM(2, max_batch).do_load_model(jm, params, state)
    tim = InferenceModel(2, max_batch, device="cpu").do_load_model(tm)
    if bits:
        jim.do_quantize(None, force=True, bits=bits)
        tim.do_quantize(None, force=True, bits=bits)
    want = jaot.resolve_manifest(jim, spec)
    got = taot.resolve_manifest(tim, spec)
    assert got == want and len(got) > 1
    assert {e.variant for e in got} == {"w4" if bits else "float"}


def test_warm_then_predict_matches_jax():
    """``aot.warm_up`` over the bucket ladder, then ``do_predict`` and
    ``dispatch`` at odd sizes: within 1e-5 of the JAX package; the stats
    documents carry the JAX package's keys.  A warm entry runs its bucket
    once and captures nothing; every later call finds its bucket warm."""
    jm, params, state, tm = _pair()
    jim = JaxIM(2, 8).do_load_model(jm, params, state)
    tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
    spec = {"scales": "off"}
    doc = taot.warm_up(tim, taot.resolve_manifest(tim, spec))
    jdoc = jaot.warm_up(jim, jaot.resolve_manifest(jim, spec))
    assert set(doc) == set(jdoc)
    assert doc["programs"] == doc["compiled"] == 4 and doc["failed"] == 0
    assert doc["compile_stats"]["captures"] == 0
    assert not tim.warm(8, (T,))
    for n in (3, 8, 13):
        ids = _ids(60 + n, n)
        np.testing.assert_allclose(tim.do_predict(ids, batch_size=4),
                                   jim.do_predict(ids, batch_size=4),
                                   atol=ATOL)
    ids = _ids(70, 5)
    np.testing.assert_allclose(tim.dispatch(ids).result(),
                               jim.dispatch(ids).result(), atol=ATOL)
    st = tim.aot_stats()
    assert set(st) == set(jim.aot_stats())
    assert st["compiles"] == st["cached_programs"] == 4 and st["hits"] == 8
    # chunks of 4 rows: 3 -> one, 8 -> two, 13 -> three and a 1-row one;
    # the dispatch of 5 rows pads to 8
    assert st["programs"] == {f"b4x{T}/<f4": 6, f"b1x{T}/<f4": 1,
                              f"b8x{T}/<f4": 1}
    epoch = st["epoch"]
    tim.do_load_model(tm)                   # a new program: warm again
    assert tim.aot_stats()["epoch"] == epoch + 1
    assert tim.aot_stats()["programs"] == {}
    assert tim.warm(8, (T,))


def test_engine_predict_warms_its_buckets():
    _, _, _, tm = _pair()
    tim = InferenceModel(2, 8, device="cpu").do_load_model(tm)
    q = InProcQueue()
    spec = {"max_batch": 4, "scales": "off"}
    serving = teng.ClusterServing(tim, q, teng.ServingParams(
        batch_size=4, max_wait_ms=2.0, warmup=spec))
    iq, oq = InputQueue(q), OutputQueue(q)
    ids = _ids(80, 6)
    serving.start()
    try:
        for _ in range(600):
            w = serving.health()["warmup"]
            if w["state"] not in ("pending", "warming"):
                break
            time.sleep(0.01)
        for i, row in enumerate(ids):
            iq.enqueue_tensor(f"w{i}", row)
        res = oq.query_many([f"w{i}" for i in range(6)], timeout_s=60.0)
    finally:
        serving.shutdown(drain_s=2.0)
    assert w["state"] == "ready" and w["failed"] == 0
    assert w["total"] == len(taot.resolve_manifest(tim, spec)) == 3
    want = tim.do_predict(ids)
    for i in range(6):
        top = res[f"w{i}"]["value"]
        assert top[0][0] == int(np.argmax(want[i]))


# -- the serving engine's predict plane -------------------------------------------

def _records(n, seed=30):
    ids = _ids(seed, n)
    return [(f"r{i}", {"uri": f"r{i}",
                       "b64": base64.b64encode(ids[i].tobytes()).decode(),
                       "dtype": "<f4", "shape": [T]})
            for i in range(n)]


def test_engine_predict_matches_jax(models):
    """The same records through both engines' synchronous drive: equal
    top-N class lists, probabilities within ATOL."""
    jim, tim = models
    recs = _records(7)
    jq, tq = JaxQueue(), InProcQueue()
    for rid, rec in recs:
        jq.xadd(dict(rec))
        tq.xadd(dict(rec))
    js = jeng.ClusterServing(jim, jq, jeng.ServingParams(batch_size=4,
                                                         top_n=3))
    ts = teng.ClusterServing(tim, tq, teng.ServingParams(batch_size=4,
                                                         top_n=3))
    served = 0
    while served < len(recs):
        n = ts.serve_once()
        assert n > 0
        served += n
    while js.serve_once():
        pass
    rids = [rid for rid, _ in recs]
    want, got = jq.get_results(rids), tq.get_results(rids)
    for rid in rids:
        w, g = want[rid]["value"], got[rid]["value"]
        assert [c for c, _ in g] == [c for c, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   atol=ATOL)
    assert ts.total_records == len(recs)
    h = ts.health()
    assert h["quantized_bits"] == 0 and "generation" not in h
    js.shutdown()
    ts.shutdown()


def test_engine_predict_pipelined_with_quarantine_and_shed(models):
    """The three supervised workers end to end: every good record is
    answered, a record the model cannot take is dead-lettered alone, a
    late record is shed."""
    _, tim = models
    q = InProcQueue()
    serving = teng.ClusterServing(tim, q, teng.ServingParams(
        batch_size=4, max_wait_ms=2.0, inflight_batches=8))
    iq, oq = InputQueue(q), OutputQueue(q)
    ids = _ids(40, 9)
    serving.start()
    try:
        assert {s.name for s in serving._sups} == {
            "serving-preprocess", "serving-predict", "serving-write"}
        assert serving._writeq.maxsize == tim.concurrent_num
        for i, row in enumerate(ids):
            iq.enqueue_tensor(f"ok{i}", row)
        iq.enqueue_tensor("long", np.zeros(T + 3, np.float32))
        q.xadd({"uri": "late", "data": [1.0] * T,
                "deadline_ns": 1})
        res = oq.query_many([f"ok{i}" for i in range(9)] + ["long", "late"],
                            timeout_s=60.0)
        h = serving.health()
    finally:
        serving.shutdown(drain_s=2.0)
    want = tim.do_predict(ids)
    for i in range(9):
        top = res[f"ok{i}"]["value"]
        assert len(top) == 5
        assert top[0][0] == int(np.argmax(want[i]))
        np.testing.assert_allclose(top[0][1], want[i].max(), atol=ATOL)
    assert OutputQueue.is_error(res["long"])
    assert "long" in {e["uri"] for e in q.dead_letters()}
    assert OutputQueue.is_deadline_exceeded(res["late"])
    assert serving.total_records == 9 and serving.dead_lettered == 1
    assert serving.shed == 1
    assert h["stages"]["predict"]["count"] >= 3
    assert h["ready"]["ready"]


def test_engine_image_records_are_quarantined_alone(models):
    _, tim = models
    q = InProcQueue()
    q.xadd({"uri": "img", "image": "AAAA"})
    for rid, rec in _records(2, seed=41):
        q.xadd(rec)
    serving = teng.ClusterServing(tim, q, teng.ServingParams(batch_size=4))
    assert serving.serve_once() == 2
    assert OutputQueue.is_error(q.get_results(["img"])["img"])
    serving.shutdown()


def test_default_postprocess_matches_jax():
    p = np.random.default_rng(50).random(40).astype(np.float32)
    for n in (1, 5, 40, 60):
        assert teng.default_postprocess(p, n) == \
            jeng.default_postprocess(p, n)


@pytest.mark.parametrize("spec", [None, False, "int8", "int4", 8, 4,
                                  {"bits": 4, "group_size": 32},
                                  {"bits": 8, "calib": "x.npy",
                                   "percentile": 99.9}])
def test_resolve_quantize_spec_matches_jax(spec):
    assert teng.resolve_quantize_spec(spec) == \
        jeng.resolve_quantize_spec(spec)


def test_predict_plane_params_accept_the_jax_defaults():
    p = teng.ServingParams.from_dict({"top_n": 3, "filter_threshold": 0.2,
                                      "inflight_batches": 4,
                                      "quantize": "int4"})
    assert (p.top_n, p.filter_threshold, p.inflight_batches) == (3, 0.2, 4)
    assert p.quantize["bits"] == 4 and p.generation is None
