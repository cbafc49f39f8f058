"""PyTorch port: zouwu's forecasters against the JAX package on the CPU.

The same seeded numpy windows go through the JAX model and the port's,
the JAX weights carried across with ``set_weights``:

- ``LSTMForecaster``, ``Seq2SeqForecaster``, ``MTNetForecaster`` and
  ``MTNetLayer`` (``ar_size`` 0 and > 0): param trees with the JAX keys
  and shapes, outputs and the gradients of an MSE in eval mode within
  TOL;
- ``fit`` (dropout 0, Adam, batch 16) for three epochs: each epoch's
  loss within TOL of the JAX ``fit``'s;
- ``MTNetForecaster``'s lookback check;
- int8 / int4 ``InferenceModel`` predict of the LSTM forecaster against
  the JAX package's ``do_quantize`` + ``do_predict`` on the same weights
  and calibration batch (codes and scales exactly, predictions within
  PRED_ATOL, as the earlier quantized parity tests); MTNet quantizes no
  layer in either package and predicts as in f32.

TOL = 1e-5: f32 sums in another order through 8-16 recurrent steps.
PRED_ATOL = 1e-6 on quantized predictions (the session tests' tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.models import Sequential as JSequential
from analytics_zoo_tpu.zouwu import forecast as jforecast
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import init_context
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.nn.module import Layer
from analytics_zoo_tpu_torch.utils.convert import export_params
from analytics_zoo_tpu_torch.zouwu import forecast as tforecast

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
PRED_ATOL = 1e-6


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


def _grads(layer):
    """The layer's gradients in its JAX-layout tree."""
    def walk(v):
        if isinstance(v, Layer):
            return walk(v._tree())
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v.grad.detach().numpy()
    return walk(layer._tree())


FORECASTERS = {
    "lstm": (dict(horizon=2, feature_dim=3, lookback=8, lstm_1_units=6,
                  lstm_2_units=4), "LSTMForecaster"),
    "seq2seq": (dict(horizon=3, feature_dim=2, lookback=7, latent_dim=5),
                "Seq2SeqForecaster"),
    "mtnet": (dict(horizon=2, feature_dim=3, lookback=12, cnn_filters=4,
                   cnn_kernel=3, ar_window=2, long_num=2, uni_size=5),
              "MTNetForecaster"),
    "mtnet_no_ar": (dict(horizon=1, feature_dim=2, lookback=8,
                         cnn_filters=3, cnn_kernel=2, ar_window=0,
                         long_num=1, uni_size=4), "MTNetForecaster"),
}


def _pair(kind, seed=0, **over):
    kw, cls = FORECASTERS[kind]
    kw = dict(kw, **over)
    jf = getattr(jforecast, cls)(**kw)
    params = _np(jf.model.init_weights(jax.random.PRNGKey(seed)))
    tf = getattr(tforecast, cls)(**kw, device="cpu")
    tf.set_weights(params)
    return jf, tf, params, kw


def _windows(kw, n, seed):
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, kw["lookback"], kw["feature_dim"])).astype(
        np.float32)
    y = g.normal(size=(n, kw["horizon"])).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", sorted(FORECASTERS))
def test_forecaster_output_and_gradients_match_jax(kind):
    jf, tf, params, kw = _pair(kind)
    assert sorted(_leaves(export_params(tf.model))) == sorted(
        _leaves(params))
    if kind == "mtnet_no_ar":
        assert "ar" not in params["mt_net"] and not hasattr(
            tf.model.graph_layers[0], "ar_W")
    x, y = _windows(kw, 10, 1)
    want = jf.predict(x, batch_size=4)
    got = tf.predict(x, batch_size=4)
    assert got.shape == want.shape == (10, kw["horizon"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    model, state = jf.model, jf.model._state

    def loss(p):
        out, _ = model.apply(p, state, jnp.asarray(x), training=False)
        return jnp.mean((out - y) ** 2)
    jgrad = _leaves(_np(jax.grad(loss)(jax.tree.map(jnp.asarray, params))))
    tf.model.eval()
    out = tf.model(torch.as_tensor(x))
    ((out - torch.as_tensor(y)) ** 2).mean().backward()
    tgrad = _leaves(_grads(tf.model))
    assert sorted(tgrad) == sorted(jgrad)
    for path in jgrad:
        np.testing.assert_allclose(tgrad[path], jgrad[path], atol=TOL,
                                   rtol=TOL, err_msg=path)


@pytest.mark.parametrize("ar_size", [0, 3])
def test_mtnet_layer_in_a_sequential_matches_jax(ar_size):
    """The layer as ``_build_trial_model`` uses it: a Sequential of one
    ``MTNetLayer``; its sub-layers registered (``.to``, the optimizer and
    ``export_params`` see them)."""
    geo = dict(horizon=2, time_step=3, long_num=3, filters=4, kernel=2,
               uni_size=5, ar_size=ar_size, dropout=0.2)
    jm = JSequential(name="mt")
    jm.add(jforecast.MTNetLayer(input_shape=(12, 2), name="mtl", **geo))
    tm = Sequential(name="mt")
    tm.add(tforecast.MTNetLayer(input_shape=(12, 2), name="mtl", **geo))
    params = _np(jm.init_weights(jax.random.PRNGKey(3)))
    tm.set_weights(params)
    layer = tm.layers_list[0]
    assert [c.name for c in layer.sublayers()] == [
        f"mtl_{k}_{w}" for w in "mcq" for k in ("conv", "gru")]
    assert layer.param_count() == sum(
        a.size for a in jax.tree.leaves(params))
    x = np.random.default_rng(4).normal(size=(6, 12, 2)).astype(np.float32)
    want = np.asarray(jm.apply(params, jm._state, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["lstm", "mtnet"])
def test_forecaster_fit_matches_jax(kind):
    """Dropout 0 (the draws differ by design), Adam 5e-3, batch 16, three
    epochs: each epoch's mean loss within TOL, the trained parameters
    within 5e-5."""
    jf, tf, _, kw = _pair(kind, seed=2, dropout=0.0)
    x, y = _windows(kw, 48, 5)
    jax_context().set_seed(42)
    jf.compile(optimizer=jopt.Adam(5e-3), loss="mse")
    tf.compile(optimizer=topt.Adam(5e-3), loss="mse")
    want = jf.fit(x, y, batch_size=16, nb_epoch=3).history["loss"]
    got = tf.fit(x, y, batch_size=16, nb_epoch=3).history["loss"]
    assert len(got) == len(want) == 3 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jp, tp = _leaves(_np(jf.model._params)), _leaves(export_params(tf.model))
    for path in jp:
        np.testing.assert_allclose(tp[path], jp[path], atol=5e-5,
                                   err_msg=path)


def test_mtnet_lookback_must_match_blocks():
    for mod, extra in ((jforecast, {}), (tforecast, {"device": "cpu"})):
        with pytest.raises(ValueError, match="lookback=17"):
            mod.MTNetForecaster(lookback=17, long_num=3, time_step=4,
                                **extra)
    f = tforecast.MTNetForecaster(lookback=20, long_num=3, device="cpu")
    assert f.time_step == 5


def _quantized(kind, bits):
    jf, tf, params, kw = _pair(kind, seed=7)
    calib, _ = _windows(kw, 32, 8)
    jim = JaxIM(2, 64).do_load_model(jf.model, params, jf.model._state)
    tim = InferenceModel(2, 64, device="cpu").do_load_model(tf.model)
    jim.do_quantize(calib if bits == 8 else None, force=True, bits=bits)
    tim.do_quantize(calib if bits == 8 else None, force=True, bits=bits)
    x, _ = _windows(kw, 20, 9)
    return jim, tim, x


@pytest.mark.parametrize("bits", [8, 4])
def test_lstm_forecaster_quantized_matches_jax(bits):
    """The Dense head's codes and scales exactly (``s_x`` within rtol
    1e-6), the LSTMs untouched, predictions within PRED_ATOL."""
    jim, tim, x = _quantized("lstm", bits)
    want, got = _leaves(_np(jim._params)), _leaves(tim._params)
    assert sorted(got) == sorted(want)
    for path in want:
        if path.endswith("/s_x"):
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    key = "zf_out/W_q" if bits == 8 else "zf_out/W_q4"
    assert key in got and sum(p.endswith("/Wx") for p in got) == 2
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16),
                               atol=PRED_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_mtnet_quantizes_no_layer(bits):
    """The quantizer walks only Sequential / Model layer lists: MTNet's
    encoders and heads stay float in both packages, and the quantized
    model predicts as the float one."""
    jim, tim, x = _quantized("mtnet", bits)
    for tree in (_leaves(_np(jim._params)), _leaves(tim._params)):
        assert not any(p.rsplit("/", 1)[-1] in ("W_q", "W_q4", "s_x")
                       for p in tree)
    jf, tf, params, _ = _pair("mtnet", seed=7)
    np.testing.assert_array_equal(tim.do_predict(x, batch_size=16),
                                  tf.predict(x, batch_size=16))
    np.testing.assert_allclose(tim.do_predict(x, batch_size=16),
                               jim.do_predict(x, batch_size=16), atol=TOL)


def test_forecasters_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in ("LSTMForecaster", "Seq2SeqForecaster", "MTNetForecaster"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tforecast, cls)()
        model = getattr(tforecast, cls)(device="cpu").model
        assert {p.device for p in model.parameters()} == {
            torch.device("cpu")}
