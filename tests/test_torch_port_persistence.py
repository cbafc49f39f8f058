"""PyTorch port: weights persistence and ``summary`` against the JAX
package on the CPU.

- ``save_weights`` / ``load_weights`` both ways between the packages, for
  a ``Sequential``, a graph ``Model`` with BatchNormalization state and a
  ``ZooModel``: the two files hold the same keys with the same values,
  a model loaded from either file predicts exactly as one given the
  weights directly, and within TOL of the JAX model;
- ``utils/serialization``: ``save_pytree`` / ``load_pytree`` with and
  without a template, lists and empty subtrees, and the ``KeyError`` of a
  missing leaf, as the JAX module;
- ``TimeSequencePipeline`` and ``TSPipeline`` directories saved by one
  package load in the other, with predictions within TOL;
- ``summary``'s printed lines equal to the JAX package's.

TOL = 1e-5: the same weights, f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.automl import feature as jfeature
from analytics_zoo_tpu.automl import regression as jregression
from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.nn import graph as jgraph
from analytics_zoo_tpu.nn import models as jmodels
from analytics_zoo_tpu.nn.layers import conv as jconv
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import recurrent as jrec
from analytics_zoo_tpu.utils import serialization as jser
from analytics_zoo_tpu.zouwu import forecast as jforecast
from analytics_zoo_tpu_torch.automl import feature as tfeature
from analytics_zoo_tpu_torch.automl import regression as tregression
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import init_context
from analytics_zoo_tpu_torch.nn import graph as tgraph
from analytics_zoo_tpu_torch.nn import models as tmodels
from analytics_zoo_tpu_torch.nn.layers import conv as tconv
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import recurrent as trec
from analytics_zoo_tpu_torch.utils import serialization as tser
from analytics_zoo_tpu_torch.utils.convert import export_params, export_state
from analytics_zoo_tpu_torch.zouwu import forecast as tforecast

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5


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


def _sequential(m):
    s = m["models"].Sequential(name="persist_seq")
    s.add(m["rec"].LSTM(5, return_sequences=True, input_shape=(6, 3),
                        name="p_lstm"))
    s.add(m["rec"].GRU(4, name="p_gru"))
    s.add(m["core"].Dropout(0.3, name="p_drop"))
    s.add(m["core"].Dense(2, activation="tanh", name="p_out"))
    return s, (6, 3)


def _graph(m):
    inp = m["graph"].Input(shape=(6, 6, 2), name="p_in")
    a = m["conv"].Convolution2D(3, 3, border_mode="same", name="p_conv")(inp)
    a = m["core"].BatchNormalization(name="p_bn")(a)
    a = m["core"].Flatten(name="p_flat")(a)
    b = m["core"].Flatten(name="p_flat_in")(inp)
    b = m["core"].Dense(108, name="p_proj")(b)
    h = m["core"].merge([a, b], mode="sum", name="p_sum")
    out = m["core"].Dense(3, activation="softmax", name="p_head")(h)
    return m["models"].Model(input=inp, output=out, name="persist_graph"), \
        (6, 6, 2)


JAX_MODS = {"models": jmodels, "rec": jrec, "core": jcore, "conv": jconv,
            "graph": jgraph}
PORT_MODS = {"models": tmodels, "rec": trec, "core": tcore, "conv": tconv,
             "graph": tgraph}
MODELS = {"sequential": _sequential, "graph": _graph}


def _pair(kind, seed=0):
    jm, shape = MODELS[kind](JAX_MODS)
    tm, _ = MODELS[kind](PORT_MODS)
    params = _np(jm.init_weights(jax.random.PRNGKey(seed)))
    state = _np(jm._state)
    if kind == "graph":          # moving statistics off their init
        g = np.random.default_rng(seed)
        state["p_bn"] = {"mean": g.normal(size=3).astype(np.float32),
                         "var": g.uniform(0.5, 2.0, 3).astype(np.float32)}
        jm._state = jax.tree.map(jnp.asarray, state)
    tm.set_weights(params, state)
    return jm, tm, shape


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_weights_files_cross_between_packages(kind, tmp_path):
    jm, tm, shape = _pair(kind)
    jm.save_weights(str(tmp_path / "jax.npz"))
    tm.save_weights(str(tmp_path / "port.npz"))
    jz, tz = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port.npz")
    assert sorted(jz) == sorted(tz)
    assert any(k.startswith("state/") for k in jz) == (kind == "graph")
    for k in jz:
        assert jz[k].dtype == tz[k].dtype
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    x = np.random.default_rng(1).normal(size=(5,) + shape).astype(
        np.float32)
    ref = tm.predict(x, batch_size=8)
    np.testing.assert_allclose(ref, jm.predict(x, batch_size=8), atol=TOL)
    # the port loads the JAX file into a fresh model (other weights)
    fresh, _ = MODELS[kind](PORT_MODS)
    fresh.init_weights(9)
    assert fresh.load_weights(str(tmp_path / "jax.npz")) is fresh
    np.testing.assert_array_equal(fresh.predict(x, batch_size=8), ref)
    for k, v in _np(jm._state).items():
        for leaf, arr in v.items():
            np.testing.assert_array_equal(
                export_state(fresh)[k][leaf].numpy(), arr)
    # and the JAX package loads the port's file into an unbuilt model
    jfresh, _ = MODELS[kind](JAX_MODS)
    jfresh.load_weights(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(jfresh.predict(x, batch_size=8), ref,
                               atol=TOL)


def test_zoo_model_weights_cross_between_packages(tmp_path):
    kw = dict(horizon=2, feature_dim=2, lookback=6, lstm_1_units=5,
              lstm_2_units=3)
    jf = jforecast.LSTMForecaster(**kw)
    jf.init_weights(jax.random.PRNGKey(4))
    jf.save_weights(str(tmp_path / "jax.npz"))
    tf = tforecast.LSTMForecaster(**kw, device="cpu")
    assert tf.load_weights(str(tmp_path / "jax.npz")) is tf
    tf.save_weights(str(tmp_path / "port.npz"))
    assert _npz(tmp_path / "port.npz").keys() == _npz(
        tmp_path / "jax.npz").keys()
    x = np.random.default_rng(2).normal(size=(7, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(tf.predict(x), jf.predict(x), atol=TOL)
    jf2 = jforecast.LSTMForecaster(**kw)
    jf2.load_weights(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(jf2.predict(x), jf.predict(x), atol=0)


def test_missing_leaf_raises_key_error(tmp_path):
    _, tm, _ = _pair("sequential")
    tm.save_weights(str(tmp_path / "w"))               # .npz appended
    bigger = tmodels.Sequential(name="persist_seq")
    for layer in _sequential(PORT_MODS)[0].layers_list:
        bigger.add(layer)
    bigger.add(tcore.Dense(1, name="p_extra"))
    for path in (str(tmp_path / "w.npz"), str(tmp_path / "w")):
        with pytest.raises(KeyError, match="missing leaf 'params/p_extra/"):
            bigger.load_weights(path)
    jbig = jmodels.Sequential(name="persist_seq")
    for layer in _sequential(JAX_MODS)[0].layers_list:
        jbig.add(layer)
    jbig.add(jcore.Dense(1, name="p_extra"))
    with pytest.raises(KeyError, match="missing leaf 'params/p_extra/"):
        jbig.load_weights(str(tmp_path / "w.npz"))


def test_pytree_files_match_the_jax_module(tmp_path):
    g = np.random.default_rng(3)
    tree = {"b": {"x": g.normal(size=(2, 3)).astype(np.float32),
                  "empty": {}, "none": None},
            "a": [g.integers(0, 9, (4,)), {"k": np.float32(2.5)}],
            "c": g.normal(size=()).astype(np.float32)}
    tser.save_pytree(str(tmp_path / "t.npz"), tree)
    jser.save_pytree(str(tmp_path / "j.npz"), tree)
    tz, jz = _npz(tmp_path / "t.npz"), _npz(tmp_path / "j.npz")
    assert sorted(tz) == sorted(jz) == ["a/0", "a/1/k", "b/x", "c"]
    for k in jz:
        np.testing.assert_array_equal(tz[k], jz[k])
    for path in ("t.npz", "j.npz"):
        got = tser.load_pytree(str(tmp_path / path))
        want = jser.load_pytree(str(tmp_path / path))
        assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
        got = tser.load_pytree(str(tmp_path / path), like=tree)
        want = jser.load_pytree(str(tmp_path / path), like=tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    like = dict(tree, d={"y": np.zeros(1)})
    for mod in (tser, jser):
        with pytest.raises(KeyError, match="missing leaf 'd/y'"):
            mod.load_pytree(str(tmp_path / "t.npz"), like=like)


def _series(n, seed):
    g = np.random.default_rng(seed)
    t = np.arange(n)
    return pd.DataFrame({
        "datetime": pd.date_range("2014-07-01", periods=n, freq="30min"),
        "value": 10 + 4 * np.sin(2 * np.pi * t / 48) + g.normal(0, 0.3, n),
        "temp": g.normal(20, 3, n)})


PIPE_CFGS = {
    "lstm2": {"model": "LSTM", "lstm_1_units": 6, "dropout_1": 0.2,
              "lstm_units": 4, "dropout": 0.3, "lookback": 8, "horizon": 1,
              "selected_features": ["HOUR", "WEEKEND", "MINUTE", "temp"]},
    "mtnet": {"model": "MTNet", "time_step": 3, "long_num": 2,
              "filter_size": 4, "ar_size": 2, "dropout": 0.1,
              "lookback": 9, "horizon": 2},
}


@pytest.mark.parametrize("kind", sorted(PIPE_CFGS))
def test_pipelines_cross_between_packages(kind, tmp_path):
    cfg = PIPE_CFGS[kind]
    df = _series(200, 5)
    feats = tuple(cfg.get("selected_features", ("HOUR", "DAYOFWEEK",
                                                "WEEKEND")))
    jft = jfeature.TimeSequenceFeatureTransformer(extra_features_col=["temp"])
    x, _ = jft.fit_transform(df, lookback=cfg["lookback"],
                             horizon=cfg["horizon"], dt_features=feats)
    jm = jregression._build_trial_model(cfg, x.shape[1:])
    jm.init_weights(jax.random.PRNGKey(6))
    jpipe = jregression.TimeSequencePipeline(jm, jft, cfg)
    want = jpipe.predict(df)
    jforecast.TSPipeline(jpipe).save(str(tmp_path / "jax"))
    tpipe = tforecast.TSPipeline.load(str(tmp_path / "jax"), device="cpu")
    got = tpipe.predict(df)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL * 10, rtol=TOL)
    tpipe.save(str(tmp_path / "port"))
    assert (tmp_path / "port" / "pipeline.json").read_text() == \
        (tmp_path / "jax" / "pipeline.json").read_text()
    back = jregression.TimeSequencePipeline.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.predict(df), want)
    again = tregression.TimeSequencePipeline.load(str(tmp_path / "port"),
                                                  device="cpu")
    np.testing.assert_array_equal(again.predict(df), got)
    assert isinstance(again.ft, tfeature.TimeSequenceFeatureTransformer)
    ev_t = tpipe.evaluate(df, ("mse", "smape"))
    ev_j = jforecast.TSPipeline(jpipe).evaluate(df, ("mse", "smape"))
    for k in ev_j:
        assert abs(ev_t[k] - ev_j[k]) <= 1e-4 * max(1.0, abs(ev_j[k])), k


SUMMARIES = {
    "sequential": lambda m: _sequential(m)[0],
    "graph": lambda m: _graph(m)[0],
    "lstm_forecaster": lambda m: m["forecast"].LSTMForecaster(
        lookback=5, feature_dim=2, **m["dev"]),
    "mtnet_forecaster": lambda m: m["forecast"].MTNetForecaster(
        lookback=8, feature_dim=2, cnn_filters=3, **m["dev"]),
}


@pytest.mark.parametrize("kind", sorted(SUMMARIES))
def test_summary_prints_the_jax_rows(kind):
    lines = {}
    for tag, mods in (("jax", dict(JAX_MODS, forecast=jforecast, dev={})),
                      ("port", dict(PORT_MODS, forecast=tforecast,
                                    dev={"device": "cpu"}))):
        out = []
        total = SUMMARIES[kind](mods).summary(print_fn=out.append)
        lines[tag] = (out, total)
    assert lines["port"] == lines["jax"]
    assert len(lines["port"][0]) > 6
