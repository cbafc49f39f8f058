"""PyTorch port: ``SessionRecommender`` and ``AnomalyDetector`` against the
JAX package on the CPU.

The same seeded numpy inputs go through the JAX model and the port's, the
JAX weights carried across with ``set_weights``:

- ``SessionRecommender`` with and without its history branch at a narrow
  width (50 items, embed 8, GRU (6, 4), MLP (5, 3)): ``predict`` and its
  graph; ``Estimator.fit`` step by step for 3 steps (each loss, then the
  trained parameters); ``recommend_for_session``; int8 and int4
  ``InferenceModel`` predict against the JAX package's ``do_quantize`` +
  ``do_predict`` on the same weights and calibration batch (weight codes
  and scales, every quantized layer's activation codes, probabilities);
- ``AnomalyDetector``: ``unroll`` and ``detect_anomalies`` exactly;
  ``predict`` in eval mode; ``Estimator.fit`` step by step with dropouts
  0; the dropout layers by the statistics of their draws (ROADMAP's rule
  for operations driven by a random generator).

PRED_ATOL = 1e-6 on probabilities and predictions: f32 sums of up to 50
terms in another order (XLA against PyTorch's CPU kernels), read at
~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.anomalydetection import \
    AnomalyDetector as JaxAD
from analytics_zoo_tpu.models.recommendation.session_recommender import \
    SessionRecommender as JaxSR
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.ops import quant_matmul as jqm
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import (ZooConf, ZooContext,
                                                    init_context)
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.recommendation import SessionRecommender
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM
from analytics_zoo_tpu_torch.ops import quant_matmul as tqm
from analytics_zoo_tpu_torch.utils.convert import export_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

PRED_ATOL = 1e-6
ITEMS = 50
SR_GEO = dict(item_embed=8, rnn_hidden_layers=(6, 4), session_length=5,
              mlp_hidden_layers=(5, 3), history_length=3)


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


def _sr_pair(history, seed=0):
    js = JaxSR(ITEMS, include_history=history, **SR_GEO)
    params = _np(js.model.init_weights(jax.random.PRNGKey(seed)))
    ts = SessionRecommender(ITEMS, include_history=history, **SR_GEO,
                            device="cpu")
    ts.set_weights(params)
    return js, ts, params


def _sessions(seed, n, history):
    g = np.random.default_rng(seed)
    x = [g.integers(1, ITEMS + 1, (n, SR_GEO["session_length"]))
         .astype(np.float32)]
    if history:
        x.append(g.integers(1, ITEMS + 1, (n, SR_GEO["history_length"]))
                 .astype(np.float32))
    return x


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_predict_matches_jax(history):
    js, ts, params = _sr_pair(history)
    assert ts.model.param_count() == sum(
        a.size for a in jax.tree.leaves(params))
    assert sorted(_leaves(export_params(ts.model))) == sorted(
        _leaves(params))
    assert [type(m) for m in ts.model.graph_layers
            if isinstance(m, (GRU, Dense))].count(GRU) == 2
    x = _sessions(1, 20, history)
    want = js.predict(x if history else x[0], batch_size=8)
    got = ts.predict(x if history else x[0], batch_size=8)
    assert got.shape == want.shape == (20, ITEMS + 1)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_fit_matches_jax(history):
    """Three Adam steps of batch 8 (the JAX ``Estimator`` on the CPU mesh
    splits a batch over 8 devices): each step's loss within 1e-5, the
    trained parameters within 5e-5 (a twentieth of lr)."""
    js, ts, params = _sr_pair(history, seed=2)
    x = _sessions(3, 24, history)
    y = np.random.default_rng(4).integers(1, ITEMS + 1, (24, 1))
    jax_context().set_seed(42)
    je = JaxEstimator(js.model, optimizer=jopt.Adam(1e-3),
                      loss="sparse_categorical_crossentropy")
    te = Estimator(ts.model, optimizer=topt.Adam(1e-3),
                   loss="sparse_categorical_crossentropy",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    xin = x if history else x[0]
    je.fit(xin, y, batch_size=8, epochs=1, verbose=False)
    te.fit(xin, y, batch_size=8, epochs=1, verbose=False)
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-5)
    want = _leaves(_np(je.params))
    got = _leaves(export_params(ts.model))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=5e-5,
                                   err_msg=path)


@pytest.mark.parametrize("history", [False, True])
def test_recommend_for_session_matches_jax(history):
    """The same items in the same order, each probability within
    PRED_ATOL (no two of a session's top probabilities lie within 1e-7 of
    each other here, so the orders cannot part)."""
    js, ts, _ = _sr_pair(history, seed=5)
    x = _sessions(6, 4, history)
    hist = x[1] if history else None
    want = js.recommend_for_session(x[0], max_items=7, history=hist)
    got = ts.recommend_for_session(x[0], max_items=7, history=hist)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                                   atol=PRED_ATOL)
        assert all(p >= q for (_, p), (_, q) in zip(a, a[1:]))


def _record_codes(monkeypatch, mod):
    seen = []

    def spy(x_q, *args, _fn=mod.w8a8_dense, **kwargs):
        seen.append(np.array(x_q.cpu() if isinstance(x_q, torch.Tensor)
                             else x_q))
        return _fn(x_q, *args, **kwargs)
    monkeypatch.setattr(mod, "w8a8_dense", spy)
    return seen


def _quantized(history, bits):
    js, ts, params = _sr_pair(history, seed=7)
    calib_x = _sessions(8, 32, history)
    calib = [tuple(calib_x)] if history else [calib_x[0]]
    jim = JaxIM(2, 64).do_load_model(js.model, params, js.model._state)
    tim = InferenceModel(2, 64, device="cpu").do_load_model(ts.model)
    jim.do_quantize(calib, force=True, bits=bits)
    tim.do_quantize(calib, force=True, bits=bits)
    x = _sessions(9, 20, history)
    return jim, tim, (x if history else x[0]), (4 if history else 1), ts


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_quantized_leaves_match_jax(history, bits):
    """Weight codes and scales exactly, ``s_x`` within rtol 1e-6 (an
    absmax of an f32 activation summed in another order), every Dense
    quantized and no GRU leaf touched."""
    jim, tim, _, n_dense, _ = _quantized(history, bits)
    want, got = _leaves(_np(jim._params)), _leaves(tim._params)
    assert sorted(got) == sorted(want)
    for path in want:
        if path.endswith("/s_x"):
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    key = "/W_q" if bits == 8 else "/W_q4"
    assert sum(p.endswith(key) for p in got) == n_dense
    assert sum(p.endswith("/Wh") for p in got) == 2


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_int8_predict_matches_jax(history, monkeypatch):
    """The JAX int8 tree loaded into the port: every quantized layer's
    activation codes equal, probabilities within PRED_ATOL; the port's own
    quantized model too."""
    jim, own, x, n_dense, ts = _quantized(history, 8)
    tim = InferenceModel(2, 64, device="cpu").do_load_model(
        ts.model, _np(jim._params))
    want = jim.do_predict(x, batch_size=16)
    np.testing.assert_allclose(own.do_predict(x), want, atol=PRED_ATOL)
    jcodes = _record_codes(monkeypatch, jqm)
    tcodes = _record_codes(monkeypatch, tqm)
    xs = x if history else [x]
    jim._model.apply(jim._params, jim._state,
                     [jnp.asarray(a) for a in xs] if history
                     else jnp.asarray(x), training=False)
    got = tim.do_predict(x, batch_size=64)
    assert len(jcodes) == len(tcodes) == n_dense
    for a, b in zip(tcodes, jcodes):
        np.testing.assert_array_equal(a[:len(b)], b)
    assert got.shape == want.shape == (20, ITEMS + 1)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_int4_predict_matches_jax(history):
    jim, tim, x, _, _ = _quantized(history, 4)
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16),
                               atol=PRED_ATOL)


# -- AnomalyDetector ----------------------------------------------------------

AD_GEO = dict(feature_shape=(6, 2), hidden_layers=(5, 7, 3))


def _ad_pair(dropouts=(0.0, 0.0, 0.0), seed=0):
    ja = JaxAD(**AD_GEO, dropouts=dropouts)
    params = _np(ja.model.init_weights(jax.random.PRNGKey(seed)))
    ta = AnomalyDetector(**AD_GEO, dropouts=dropouts, device="cpu")
    ta.set_weights(params)
    return ja, ta, params


def _series(n=120, seed=3):
    g = np.random.default_rng(seed)
    t = np.arange(n)
    s = np.stack([np.sin(t / 5.0), np.cos(t / 7.0)], 1) \
        + 0.1 * g.standard_normal((n, 2))
    return s.astype(np.float32)


@pytest.mark.parametrize("step", [1, 3])
def test_unroll_and_detect_anomalies_are_exact(step):
    s = _series()
    for data in (s, s[:, 0]):
        want = JaxAD.unroll(data, 6, predict_step=step)
        got = AnomalyDetector.unroll(data, 6, predict_step=step)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    y = s[:, 0]
    yhat = y + np.random.default_rng(1).standard_normal(len(y)) * 0.1
    for frac in (0.05, 0.2, 0.001):
        want = JaxAD.detect_anomalies(y, yhat, frac)
        got = AnomalyDetector.detect_anomalies(y, yhat, frac)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_anomaly_detector_predict_matches_jax():
    """Eval mode: dropout is the identity on both sides."""
    ja, ta, params = _ad_pair((0.2, 0.3, 0.4))
    assert [type(m).__name__ for m in ta.model.layers_list] == [
        "LSTM", "Dropout", "LSTM", "Dropout", "LSTM", "Dropout", "Dense"]
    x, _ = AnomalyDetector.unroll(_series(), 6)
    want = ja.predict(x, batch_size=16)
    got = ta.predict(x, batch_size=16)
    assert got.shape == want.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)


def test_anomaly_detector_fit_matches_jax():
    """Dropouts 0: each step's MSE within 1e-5 over two epochs of batch 16
    and the trained parameters within 5e-5 (Adam 2e-3, as the example)."""
    ja, ta, params = _ad_pair(seed=4)
    x, y = AnomalyDetector.unroll(_series(), 6)
    x, y = x[:96], y[:96]
    jax_context().set_seed(42)
    je = JaxEstimator(ja.model, optimizer=jopt.Adam(2e-3), loss="mse")
    te = Estimator(ta.model, optimizer=topt.Adam(2e-3), loss="mse",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    je.fit(x, y, batch_size=16, epochs=2, verbose=False)
    te.fit(x, y, batch_size=16, epochs=2, verbose=False)
    assert len(losses["port"]) == len(losses["jax"]) == 12
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-5)
    want = _leaves(_np(je.params))
    got = _leaves(export_params(ta.model))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=5e-5,
                                   err_msg=path)


def test_anomaly_detector_dropout_by_its_statistics():
    """In training mode with a seed each dropout layer keeps a fraction
    ``1 - p`` of its inputs (within 4 standard deviations of the binomial
    draw) scaled by ``1 / (1 - p)``, and zeroes the rest; two seeds draw
    different masks; eval mode and no seed keep everything."""
    _, ta, _ = _ad_pair((0.2, 0.3, 0.4))
    n = 20000
    for layer in ta.model.layers_list:
        if type(layer).__name__ != "Dropout":
            continue
        p = layer.p
        ones = torch.ones(n)
        assert torch.equal(layer(ones), ones)          # eval mode
        layer.train()
        assert torch.equal(layer(ones), ones)          # no seed
        layer.seed_dropout(11)
        y = layer(ones)
        kept = (y != 0).float().mean().item()
        assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p),
                                   rtol=1e-6)
        layer.seed_dropout(12)
        assert not torch.equal(layer(ones), y)
        layer.seed_dropout(None)
        layer.eval()
    lstm = [m for m in ta.model.layers_list if isinstance(m, LSTM)]
    assert [m.return_sequences for m in lstm] == [True, True, False]
