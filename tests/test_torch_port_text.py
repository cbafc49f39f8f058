"""PyTorch port: the text zoo's layers, pipeline and models against the
JAX package on the CPU.

The same seeded numpy weights (the JAX model's, loaded by
``load_jax_params`` / ``set_weights``) and inputs go through both:

- 1-D layers, in f32 within TOL = 1e-5: ``Convolution1D`` with ``valid``
  and ``same`` padding (odd and even kernels: XLA's SAME pads an even
  kernel more at the end), strided, ``th`` ordering,
  ``AtrousConvolution1D``, ``MaxPooling1D`` / ``AveragePooling1D``.  The
  quantized ``Convolution1D`` with the JAX quantizer's own leaves loaded:
  int8 on the plain route bitwise in its codes, its dequantized sums and
  its output (the s32 sums are exact, then the same f32 scale and bias)
  against the JAX layer run eagerly, int4 within TOL (a dequantized f32
  conv in another order);
- ``TextSet`` exactly: word indices, ``gen_sample``, the word index
  saved by one package and loaded by the other, ``to_distributed``, and
  the relation helpers' pairs, lists and arrays;
- ``TextClassifier`` in each encoder (cnn, lstm, gru): f32 predict within
  TOL; the int8 and int4 trees of the JAX ``InferenceModel.do_quantize``
  loaded into the port: probabilities within PRED_ATOL = 1e-6 (int8's
  conv codes and sums bitwise); ``evaluate`` within PRED_ATOL; one ``fit`` step
  (Adam) within PRED_ATOL in the loss and TOL in every parameter;
  ``embedding_weights`` installed at construction and after
  ``init_weights``;
- ``KNRM``: scores within KNRM_TOL, ``evaluate_ndcg`` and
  ``evaluate_map`` equal on the same query groups; int8 and int4 served
  within KNRM_TOL.

PRED_ATOL: probabilities from f32 sums of up to 40 products in another
order, read at ~1e-7.  KNRM_TOL = 1e-5 on the sigmoid score: the
exact-sigma kernel (sigma 0.001) turns a cosine off by one f32 ulp
(~6e-8) into a kernel value off by ~1e-4 relative where a query and a doc
share a token, and the score takes that through a log and the head.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.feature import text as jtext
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.textclassification import \
    TextClassifier as JaxTC
from analytics_zoo_tpu.models import textmatching as jtm
from analytics_zoo_tpu.nn.layers import conv as jconv
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu.nn.models import Sequential as JaxSequential
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import init_context
from analytics_zoo_tpu_torch.feature import text as ttext
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import KNRM, TextClassifier
from analytics_zoo_tpu_torch.models import textmatching as ttm
from analytics_zoo_tpu_torch.nn import layers as tl
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
PRED_ATOL = 1e-6
KNRM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    init_context(device="cpu", seed=42)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v.detach().cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


def _perturbed(params, seed):
    """Every leaf moved off its initial value (zero biases count too)."""
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * g.normal(size=np.shape(a))).astype(
            np.float32), params)


# -- 1-D layers ---------------------------------------------------------------

CONV_CASES = [
    # (kernel, border_mode, stride, dilation, T)
    (5, "valid", 1, 1, 12), (5, "same", 1, 1, 11), (4, "same", 1, 1, 11),
    (4, "valid", 1, 1, 10), (3, "same", 2, 1, 10), (2, "same", 3, 1, 11),
    (3, "valid", 1, 2, 12), (4, "same", 1, 3, 13), (1, "valid", 1, 1, 9),
]


def _conv_pair(k, bm, s, d, t, cin=6, cout=7, activation="relu",
               ordering="tf", seed=0):
    kw = dict(border_mode=bm, subsample=s, activation=activation,
              dim_ordering=ordering)
    shape = (t, cin) if ordering == "tf" else (cin, t)
    if d == 1:
        jl = jconv.Convolution1D(cout, k, **kw)
        ml = tl.Convolution1D(cout, k, input_shape=shape, **kw)
    else:
        jl = jconv.AtrousConvolution1D(cout, k, atrous_rate=d, **kw)
        ml = tl.AtrousConvolution1D(cout, k, atrous_rate=d,
                                    input_shape=shape, **kw)
    p = _perturbed(_np(jl.build(jax.random.PRNGKey(seed), shape)), seed)
    load_jax_params(ml, p)
    return jl, ml, p


@pytest.mark.parametrize("k,bm,s,d,t", CONV_CASES)
def test_convolution1d_matches_jax(k, bm, s, d, t):
    jl, ml, p = _conv_pair(k, bm, s, d, t)
    x = np.random.default_rng(k + t).normal(size=(3, t, 6)).astype(
        np.float32)
    want = np.asarray(jl.call(p, jnp.asarray(x)))
    got = ml(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3,) + ml.compute_output_shape((t, 6))
    np.testing.assert_allclose(got, want, atol=TOL)
    assert tuple(ml.W.shape) == (k, 6, 7)


def test_convolution1d_th_ordering_matches_jax():
    jl, ml, p = _conv_pair(3, "same", 1, 1, 9, ordering="th")
    x = np.random.default_rng(3).normal(size=(2, 6, 9)).astype(np.float32)
    want = np.asarray(jl.call(p, jnp.asarray(x)))
    got = ml(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 7, 9)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("pool,stride,bm,t", [
    (2, None, "valid", 10), (3, 2, "valid", 11), (3, 2, "same", 10),
    (4, 1, "same", 9), (2, 3, "same", 11)])
def test_pooling1d_matches_jax(op, pool, stride, bm, t):
    jcls = jpool.MaxPooling1D if op == "max" else jpool.AveragePooling1D
    tcls = tl.MaxPooling1D if op == "max" else tl.AveragePooling1D
    kw = dict(pool_size=pool, strides=stride, border_mode=bm)
    x = np.random.default_rng(t + pool).normal(size=(2, t, 5)).astype(
        np.float32)
    want = np.asarray(jcls(**kw).call({}, jnp.asarray(x)))
    layer = tcls(**kw)
    got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2,) + layer.compute_output_shape(
        (t, 5))
    np.testing.assert_allclose(got, want, atol=TOL)


def _quantized_conv(bits, k, bm, d, t, seed):
    """A one-conv Sequential quantized by the JAX ``InferenceModel`` and
    the same tree loaded into the port's."""
    kw = dict(border_mode=bm, activation="relu", name="conv")
    if d == 1:
        jl = jconv.Convolution1D(9, k, input_shape=(t, 6), **kw)
        ml = tl.Convolution1D(9, k, input_shape=(t, 6), **kw)
    else:
        jl = jconv.AtrousConvolution1D(9, k, atrous_rate=d,
                                       input_shape=(t, 6), **kw)
        ml = tl.AtrousConvolution1D(9, k, atrous_rate=d, input_shape=(t, 6),
                                    **kw)
    jm, tm = JaxSequential([jl]), Sequential([ml])
    params = _perturbed(_np(jm.init_weights(jax.random.PRNGKey(seed))),
                        seed)
    g = np.random.default_rng(seed + 1)
    calib = g.normal(size=(8, t, 6)).astype(np.float32)
    jim = JaxIM(2, 16).do_load_model(jm, params, jm._state)
    jim.do_quantize(calib, force=True, bits=bits, group_size=16)
    tim = InferenceModel(2, 16, device="cpu").do_load_model(
        tm, _np(jim._params))
    return jim, tim, g.normal(size=(5, t, 6)).astype(np.float32)


@pytest.mark.parametrize("k,bm,d,t", [(5, "valid", 1, 12),
                                      (4, "same", 1, 11),
                                      (3, "same", 2, 13)])
def test_quantized_convolution1d_matches_jax(k, bm, d, t, monkeypatch):
    """int8: the conv's dequantized s32 sums and the layer's output
    bitwise equal to the JAX layer's (run eagerly; the JAX package's
    jitted predict fuses the bias add into the scale's multiply, one ulp
    off, so it is held within PRED_ATOL); int4 within TOL."""
    jim, tim, x = _quantized_conv(8, k, bm, d, t, seed=k + t)
    assert _leaves(tim._params)["conv/W_q"].shape == (k, 6, 9)
    jitted = jim.do_predict(x, batch_size=8)
    jseen = _record_conv(monkeypatch, jqm)
    tseen = _record_conv(monkeypatch, tqm)
    want, _ = jim._model.apply(jim._params, jim._state, jnp.asarray(x),
                               training=False)
    got = tim.do_predict(x, batch_size=8)
    np.testing.assert_array_equal(tseen[0][1][:5, 0], jseen[0][1])
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(got, jitted, atol=PRED_ATOL)
    jim4, tim4, x4 = _quantized_conv(4, k, bm, d, t, seed=k + t)
    assert _leaves(tim4._params)["conv/W_q4"].shape == (-(-k * 6 // 2), 9)
    np.testing.assert_allclose(tim4.do_predict(x4, batch_size=8),
                               jim4.do_predict(x4, batch_size=8), atol=TOL)


def test_quantized_convolution1d_is_one_conv2d_launch_at_one_row(
        monkeypatch):
    """The int8 1-D conv reaches ``w8a8_conv2d`` once, as the (1, k)
    conv of (B, 1, T, C) with the (1, k, cin, cout) weight view."""
    _, tim, x = _quantized_conv(8, 5, "same", 1, 12, seed=4)
    seen = []
    real = tqm.w8a8_conv2d

    def spy(x_q, w_q, scale, **kw):
        seen.append((tuple(x_q.shape), tuple(w_q.shape), kw["pads"]))
        return real(x_q, w_q, scale, **kw)
    monkeypatch.setattr(tqm, "w8a8_conv2d", spy)
    tim.do_predict(x, batch_size=8)
    assert seen == [((8, 1, 12, 6), (1, 5, 6, 9), [(0, 0), (2, 2)])]


# -- TextSet ------------------------------------------------------------------

WORDS = ["Alpha", "beta", "GAMMA", "delta", "eps", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron", "pi"]
PUNCT = ["", ",", ".", "!", "?", ";", "'s", " -", "..."]


def _corpus(seed, n=40):
    g = np.random.default_rng(seed)
    texts = [" ".join(WORDS[i] + PUNCT[j] for i, j in zip(
        g.zipf(1.6, g.integers(3, 30)) % len(WORDS),
        g.integers(0, len(PUNCT), 30))) for _ in range(n)]
    return texts, [int(v) for v in g.integers(0, 4, n)]


@pytest.mark.parametrize("max_words,trunc", [(-1, "pre"), (8, "post"),
                                             (12, "pre")])
def test_textset_pipeline_matches_jax(max_words, trunc, tmp_path):
    texts, labels = _corpus(max_words + 20)
    out = {}
    for name, mod in (("jax", jtext), ("port", ttext)):
        ts = mod.TextSet.from_texts(texts, labels).tokenize().normalize() \
            .word2idx(remove_topN=1, max_words_num=max_words) \
            .shape_sequence(16, trunc_mode=trunc)
        out[name] = (ts.get_word_index(), *ts.gen_sample(), ts)
    assert out["port"][0] == out["jax"][0]
    for a, b in zip(out["port"][1:3], out["jax"][1:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a word index saved by one package indexes the same in the other
    path = str(tmp_path / "wi.json")
    out["jax"][3].save_word_index(path)
    fresh = ttext.TextSet.from_texts(texts[:5]).tokenize().normalize()
    fresh.word2idx(existing_map=ttext.TextSet([]).load_word_index(
        path).get_word_index())
    assert json.load(open(path)) == out["port"][0]
    jfresh = jtext.TextSet.from_texts(texts[:5]).tokenize().normalize() \
        .word2idx(existing_map=out["port"][0])
    assert [f["indexed_tokens"] for f in fresh.features] == \
        [f["indexed_tokens"] for f in jfresh.features]
    shards = [[f["text"] for f in s.features]
              for s in out["port"][3].to_distributed(3)]
    assert shards == [[f["text"] for f in s.features]
                      for s in out["jax"][3].to_distributed(3)]


def test_textset_read_csv_matches_jax(tmp_path):
    texts, labels = _corpus(7, n=6)
    path = tmp_path / "t.csv"
    with open(path, "w") as f:
        f.write("text,label\n")
        for t, y in zip(texts, labels):
            f.write(f"\"{t}\",{y}\n")
    a = ttext.TextSet.read_csv(str(path)).tokenize().normalize() \
        .word2idx().shape_sequence(10).gen_sample()
    b = jtext.TextSet.read_csv(str(path)).tokenize().normalize() \
        .word2idx().shape_sequence(10).gen_sample()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_relation_helpers_match_jax(tmp_path):
    g = np.random.default_rng(5)
    path = tmp_path / "rel.csv"
    with open(path, "w") as f:
        f.write("id1,id2,label\n")
        for q in range(6):
            for d in g.choice(12, 5, replace=False):
                f.write(f"q{q},d{d},{int(g.random() < 0.4)}\n")
    jr, tr = jtext.read_relations(str(path)), ttext.read_relations(str(path))
    assert [(r.id1, r.id2, r.label) for r in tr] == \
        [(r.id1, r.id2, r.label) for r in jr]
    for seed in (0, 3):
        assert ttext.generate_relation_pairs(tr, seed=seed) == \
            jtext.generate_relation_pairs(jr, seed=seed)
    assert ttext.generate_relation_lists(tr) == \
        jtext.generate_relation_lists(jr)
    pairs = ttext.generate_relation_pairs(tr, seed=1)
    c1 = {f"q{i}": list(g.integers(1, 9, 4)) for i in range(6)}
    c2 = {f"d{i}": list(g.integers(1, 9, 7)) for i in range(12)}
    for a, b in zip(ttext.relation_pairs_to_arrays(pairs, c1, c2),
                    jtext.relation_pairs_to_arrays(pairs, c1, c2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- TextClassifier -----------------------------------------------------------

TC_GEO = dict(class_num=3, vocab_size=30, embedding_dim=8,
              sequence_length=12, encoder_output_dim=6)
ENCODERS = ("cnn", "lstm", "gru")


def _tc_pair(encoder, seed=0, embedding=None):
    jt = JaxTC(**TC_GEO, encoder=encoder, embedding_weights=embedding)
    params = _perturbed(_np(jt.init_weights(jax.random.PRNGKey(seed))), seed)
    if embedding is not None:
        params["tc_embedding"]["E"] = np.asarray(embedding, np.float32)
    jt.set_weights(params)
    tt = TextClassifier(**TC_GEO, encoder=encoder,
                        embedding_weights=embedding, device="cpu")
    tt.set_weights(params)
    return jt, tt, params


def _ids(seed, n=10):
    g = np.random.default_rng(seed)
    x = g.integers(1, TC_GEO["vocab_size"], (n, TC_GEO["sequence_length"]))
    x[: n // 2, -3:] = 0
    return x.astype(np.float32), g.integers(0, 3, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_text_classifier_predict_matches_jax(encoder):
    jt, tt, params = _tc_pair(encoder, seed=1)
    assert sorted(_leaves(export_params(tt.model))) == sorted(
        _leaves(params))
    x, _ = _ids(2)
    want = jt.predict(x, batch_size=4)
    got = tt.predict(x, batch_size=4)
    assert got.shape == want.shape == (10, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_text_classifier_news20_width_param_count():
    """The JAX defaults at news20's width: embedding 200, sequence 500,
    encoder 256, 20 classes, 5000 words plus padding."""
    tc = TextClassifier(20, 5001, device="cpu")
    assert tc.model.param_count() == 1_291_932
    assert tc.model.compute_output_shape((500,)) == (20,)


def _tc_quantized(encoder, bits, seed):
    jt, tt, params = _tc_pair(encoder, seed=seed)
    calib, _ = _ids(seed + 1, n=16)
    jim = JaxIM(2, 16).do_load_model(jt.model, params, jt.model._state)
    jim.do_quantize(calib, force=True, bits=bits)
    tim = InferenceModel(2, 16, device="cpu").do_load_model(
        tt.model, _np(jim._params))
    return jim, tim


def _record_conv(monkeypatch, mod):
    """Spy on ``mod.w8a8_conv``: each call's activation codes and
    output."""
    seen = []

    def spy(x_q, *args, _fn=mod.w8a8_conv, **kwargs):
        y = _fn(x_q, *args, **kwargs)
        seen.append([np.array(a.cpu() if isinstance(a, torch.Tensor) else a)
                     for a in (x_q, y)])
        return y
    monkeypatch.setattr(mod, "w8a8_conv", spy)
    return seen


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_text_classifier_quantized_matches_jax(encoder, bits):
    jim, tim = _tc_quantized(encoder, bits, seed=3 + bits)
    key = "W_q" if bits == 8 else "W_q4"
    quantized = sorted(p.split("/")[0] for p in _leaves(tim._params)
                       if p.endswith("/" + key))
    assert quantized == sorted((["tc_conv"] if encoder == "cnn" else [])
                               + ["tc_fc", "tc_out"])
    x, _ = _ids(5)
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16),
                               atol=PRED_ATOL)


def test_text_classifier_int8_conv_codes_and_sums_equal_jax(monkeypatch):
    """The int8 conv's activation codes and its dequantized s32 sums
    (``w8a8_conv``'s output, before the bias) bitwise equal to the JAX
    package's."""
    jim, tim = _tc_quantized("cnn", 8, seed=11)
    x, _ = _ids(12)
    jseen = _record_conv(monkeypatch, jqm)
    tseen = _record_conv(monkeypatch, tqm)
    jim._model.apply(jim._params, jim._state, jnp.asarray(x),
                     training=False)
    tim.do_predict(x, batch_size=16)
    assert len(jseen) == len(tseen) == 1
    (jx, jy), (tx, ty) = jseen[0], tseen[0]
    np.testing.assert_array_equal(tx[:10, 0], jx)
    np.testing.assert_array_equal(ty[:10, 0], jy)


def _compiled_pair(encoder, seed):
    jt, tt, _ = _tc_pair(encoder, seed=seed)
    for m, opt in ((jt, jopt.Adam(1e-3)), (tt, topt.Adam(1e-3))):
        m.compile(opt, "sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    jax_context().set_seed(42)
    return jt, tt


@pytest.mark.parametrize("encoder", ENCODERS)
def test_text_classifier_evaluate_matches_jax(encoder):
    jt, tt = _compiled_pair(encoder, seed=7)
    x, y = _ids(8, n=16)
    want = jt.evaluate(x, y, batch_size=8)
    got = tt.evaluate(x, y, batch_size=8)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PRED_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_text_classifier_fit_step_matches_jax(encoder):
    """One Adam step of batch 8: the loss within PRED_ATOL, every trained
    parameter within TOL."""
    jt, tt = _compiled_pair(encoder, seed=9)
    x, y = _ids(10, n=8)
    hj = jt.fit(x, y, batch_size=8, nb_epoch=1, verbose=False)
    ht = tt.fit(x, y, batch_size=8, nb_epoch=1, verbose=False)
    np.testing.assert_allclose(ht.history["loss"], hj.history["loss"],
                               atol=PRED_ATOL)
    want = _leaves(_np(jt.model._params))
    got = _leaves(export_params(tt.model))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL,
                                   err_msg=path)


def test_text_classifier_embedding_weights_installed():
    table = np.random.default_rng(0).normal(
        size=(TC_GEO["vocab_size"], TC_GEO["embedding_dim"])).astype(
        np.float32)
    tc = TextClassifier(**TC_GEO, embedding_weights=table, device="cpu")
    E = tc.model.layers_list[0].E
    assert np.array_equal(E.detach().numpy(), table)
    tc.init_weights(3)
    assert np.array_equal(E.detach().numpy(), table)
    jt, tt, _ = _tc_pair("cnn", seed=2, embedding=table)
    x, _ = _ids(3)
    np.testing.assert_allclose(tt.predict(x), jt.predict(x), atol=TOL)


def test_text_classifier_unknown_encoder_raises():
    with pytest.raises(ValueError, match="unknown encoder"):
        TextClassifier(**TC_GEO, encoder="rnn", device="cpu")


# -- KNRM ---------------------------------------------------------------------

KNRM_GEO = dict(text1_length=4, text2_length=9, vocab_size=40, embed_size=8)


def _knrm_pair(seed=0, mode="ranking"):
    jk = jtm.KNRM(**KNRM_GEO, target_mode=mode)
    params = _perturbed(_np(jk.init_weights(jax.random.PRNGKey(seed))),
                        seed)
    jk.set_weights(params)
    tk = KNRM(**KNRM_GEO, target_mode=mode, device="cpu")
    tk.set_weights(params)
    return jk, tk, params


def _knrm_groups(seed, n_groups=6, n_docs=7):
    """Query groups whose relevant docs share tokens with the query."""
    g = np.random.default_rng(seed)
    groups = []
    for _ in range(n_groups):
        q = g.integers(1, 40, KNRM_GEO["text1_length"])
        docs = g.integers(1, 40, (n_docs, KNRM_GEO["text2_length"]))
        labels = (g.random(n_docs) < 0.4).astype(np.float64)
        labels[0] = 1.0
        for i in np.nonzero(labels)[0]:
            docs[i, :2] = q[:2]
        groups.append((q.astype(np.float32), docs.astype(np.float32),
                       labels))
    return groups


@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_knrm_scores_match_jax(mode):
    jk, tk, params = _knrm_pair(seed=1, mode=mode)
    assert sorted(_leaves(export_params(tk.model))) == sorted(
        _leaves(params))
    g = np.random.default_rng(2)
    q = g.integers(0, 40, (12, 4)).astype(np.float32)
    d = g.integers(0, 40, (12, 9)).astype(np.float32)
    d[:4, :3] = q[:4, :3]                       # shared tokens: sim = 1
    want = jk.predict([q, d], batch_size=4)
    got = tk.predict([q, d], batch_size=4)
    assert got.shape == want.shape == (12, 1)
    np.testing.assert_allclose(got, want, atol=KNRM_TOL)


def test_knrm_kernel_pool_matches_jax():
    """The Lambda's kernel features on the same embeddings."""
    jk, tk, _ = _knrm_pair()
    g = np.random.default_rng(4)
    a = g.normal(size=(3, 4, 8)).astype(np.float32)
    b = np.concatenate([a[:, :2], g.normal(size=(3, 7, 8))], 1).astype(
        np.float32)
    lam = [n.layer for n in jk.model.nodes
           if n.layer is not None and n.layer.name == "knrm_kernels"][0]
    want = np.asarray(lam.call({}, [jnp.asarray(a), jnp.asarray(b)]))
    got = tk.cosine_pool([torch.from_numpy(a), torch.from_numpy(b)])
    assert got.shape == want.shape == (3, 21)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_knrm_ranking_metrics_equal_jax():
    jk, tk, _ = _knrm_pair(seed=3)
    groups = _knrm_groups(5)
    for k in (1, 3, 5):
        assert ttm.evaluate_ndcg(tk, groups, k=k, batch_size=8) == \
            jtm.evaluate_ndcg(jk, groups, k=k, batch_size=8)
    assert ttm.evaluate_map(tk, groups, batch_size=8) == \
        jtm.evaluate_map(jk, groups, batch_size=8)


@pytest.mark.parametrize("bits", [8, 4])
def test_knrm_quantized_matches_jax(bits):
    jk, tk, params = _knrm_pair(seed=6)
    g = np.random.default_rng(7)
    calib = [(g.integers(1, 40, (8, 4)).astype(np.float32),
              g.integers(1, 40, (8, 9)).astype(np.float32))]
    jim = JaxIM(2, 16).do_load_model(jk.model, params, jk.model._state)
    jim.do_quantize(calib if bits == 8 else None, force=True, bits=bits)
    tim = InferenceModel(2, 16, device="cpu").do_load_model(
        tk.model, _np(jim._params))
    assert ("W_q" if bits == 8 else "W_q4") in _np(jim._params)["knrm_out"]
    x = [g.integers(1, 40, (10, 4)).astype(np.float32),
         g.integers(1, 40, (10, 9)).astype(np.float32)]
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16),
                               atol=KNRM_TOL)
