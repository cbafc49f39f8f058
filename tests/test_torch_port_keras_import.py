"""PyTorch port: ``interop/keras_import`` against the JAX package's importer
and TensorFlow, on the CPU.

Each case builds a small tf.keras model (Sequential or functional) with
seeded weights (BatchNormalization's moving statistics made non-trivial
by a training-mode call), imports it with both packages, and runs the
same seeded numpy input through TF, the JAX import and the port's
import (eval mode).  The cases cover Dense, Conv1D / Conv2D, LSTM, GRU
in both ``reset_after`` modes, Embedding, BatchNormalization,
LayerNormalization, the 1-D and 2-D pools and global pools, Flatten,
Reshape, ZeroPadding2D, Activation, Dropout and the merge family
(Add / Subtract / Multiply / Average / Maximum / Minimum / Concatenate),
a shared layer and two inputs with two outputs.

- PORT_TOL = 1e-5 against the JAX import: the same weights, f32 sums in
  another order;
- TF_TOL = 1e-4 against TF's own output (the JAX package's oracle
  tolerance);
- the imported param trees have the JAX import's keys and values
  exactly;
- the layers the port has no counterpart for yet raise
  ``NotImplementedError`` naming their ROADMAP item.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
from tensorflow import keras  # noqa: E402

from analytics_zoo_tpu.common import dtypes as jdtypes  # noqa: E402
from analytics_zoo_tpu.interop.keras_import import \
    from_tf_keras as jax_from_tf_keras  # noqa: E402
from analytics_zoo_tpu_torch.common import dtypes as tdtypes  # noqa: E402
from analytics_zoo_tpu_torch.common.context import init_context  # noqa: E402
from analytics_zoo_tpu_torch.interop.keras_import import \
    from_tf_keras  # noqa: E402
from analytics_zoo_tpu_torch.utils.convert import export_params  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

PORT_TOL = 1e-5
TF_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    init_context(device="cpu", seed=42)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _f(g, *shape):
    return g.normal(size=shape).astype(np.float32)


def _seq_dense(g):
    m = keras.Sequential([keras.Input((12,)),
                          keras.layers.Dense(8, activation="relu"),
                          keras.layers.Dropout(0.3),
                          keras.layers.Dense(3, activation="softmax")])
    return m, _f(g, 5, 12)


def _seq_conv1d(g):
    m = keras.Sequential([keras.Input((20, 4)),
                          keras.layers.Conv1D(6, 3, padding="same",
                                              activation="relu"),
                          keras.layers.MaxPooling1D(2),
                          keras.layers.Conv1D(5, 2),
                          keras.layers.GlobalAveragePooling1D(),
                          keras.layers.Dense(2)])
    return m, _f(g, 4, 20, 4)


def _seq_conv2d(g):
    m = keras.Sequential([keras.Input((12, 12, 3)),
                          keras.layers.ZeroPadding2D(1),
                          keras.layers.Conv2D(4, 3, strides=2,
                                              activation="relu"),
                          keras.layers.BatchNormalization(),
                          keras.layers.MaxPooling2D(2),
                          keras.layers.AveragePooling2D(1),
                          keras.layers.Flatten(),
                          keras.layers.Dense(3)])
    m(_f(g, 16, 12, 12, 3), training=True)      # moving statistics
    return m, _f(g, 3, 12, 12, 3)


def _seq_recurrent(g):
    m = keras.Sequential([keras.Input((7,)),
                          keras.layers.Embedding(30, 6),
                          keras.layers.LSTM(5, return_sequences=True),
                          keras.layers.GRU(4, reset_after=True),
                          keras.layers.Dense(2)])
    return m, g.integers(0, 30, (4, 7)).astype(np.float32)


def _seq_gru_layernorm(g):
    m = keras.Sequential([keras.Input((6, 3)),
                          keras.layers.GRU(5, reset_after=False,
                                           return_sequences=True),
                          keras.layers.LayerNormalization(),
                          keras.layers.GlobalMaxPooling1D(),
                          keras.layers.Reshape((5, 1)),
                          keras.layers.Flatten(),
                          keras.layers.Dense(2, activation="tanh")])
    return m, _f(g, 4, 6, 3)


def _fn_resnet_block(g):
    inp = keras.Input((8, 8, 4))
    h = keras.layers.Conv2D(4, 3, padding="same", name="c1")(inp)
    h = keras.layers.BatchNormalization(name="bn1")(h)
    h = keras.layers.Activation("relu")(h)
    h = keras.layers.Conv2D(4, 3, padding="same", name="c2")(h)
    h = keras.layers.Add(name="skip")([h, inp])
    h = keras.layers.GlobalMaxPooling2D()(h)
    out = keras.layers.Dense(3, activation="softmax")(h)
    m = keras.Model(inp, out)
    m(_f(g, 16, 8, 8, 4), training=True)
    return m, _f(g, 3, 8, 8, 4)


def _fn_merges(g):
    i1, i2 = keras.Input((8,), name="in1"), keras.Input((8,), name="in2")
    shared = keras.layers.Dense(6, activation="relu", name="shared")
    a, b = shared(i1), shared(i2)
    merged = [keras.layers.Subtract()([a, b]), keras.layers.Multiply()([a, b]),
              keras.layers.Average()([a, b]), keras.layers.Maximum()([a, b]),
              keras.layers.Minimum()([a, b])]
    cat = keras.layers.Concatenate(axis=-1)(merged)
    o1 = keras.layers.Dense(3, name="o1")(cat)
    o2 = keras.layers.Dense(2, name="o2")(keras.layers.Add()([a, b]))
    m = keras.Model([i1, i2], [o1, o2])
    return m, [_f(g, 5, 8), _f(g, 5, 8)]


def _fn_lstm(g):
    inp = keras.Input((5, 3))
    h = keras.layers.LSTM(4, return_sequences=True)(inp)
    h = keras.layers.GRU(3, reset_after=True)(h)
    out = keras.layers.Dense(1)(h)
    return keras.Model(inp, out), _f(g, 6, 5, 3)


CASES = {"seq_dense": _seq_dense, "seq_conv1d": _seq_conv1d,
         "seq_conv2d": _seq_conv2d, "seq_recurrent": _seq_recurrent,
         "seq_gru_layernorm": _seq_gru_layernorm,
         "fn_resnet_block": _fn_resnet_block, "fn_merges": _fn_merges,
         "fn_lstm": _fn_lstm}


def _as_list(y):
    return [np.asarray(a) for a in y] if isinstance(y, (list, tuple)) \
        else [np.asarray(y)]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v.detach() if isinstance(
                v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_jax_importer_and_tf(case):
    keras.utils.set_random_seed(7)
    tf_model, x = CASES[case](np.random.default_rng(3))
    want = _as_list(tf_model(x, training=False))
    jax_model = jax_from_tf_keras(tf_model)
    jax_out = _as_list(jax_model.predict(x, batch_size=64))
    port = from_tf_keras(tf_model, device="cpu")
    assert not port.training
    jp, tp = _leaves(jax_model.get_weights()), _leaves(export_params(port))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    with torch.no_grad():
        ins = [torch.as_tensor(a) for a in x] if isinstance(x, list) \
            else torch.as_tensor(x)
        got = _as_list(port(ins))
    assert len(got) == len(want) == len(jax_out)
    for g_, j_, w_ in zip(got, jax_out, want):
        np.testing.assert_allclose(g_, j_, atol=PORT_TOL, rtol=PORT_TOL)
        np.testing.assert_allclose(g_, w_, atol=TF_TOL, rtol=TF_TOL)


@pytest.mark.parametrize("layer", ["Conv2DTranspose", "DepthwiseConv2D",
                                   "SeparableConv2D", "UpSampling2D"])
def test_unported_layers_raise(layer):
    build = {"Conv2DTranspose": lambda: keras.layers.Conv2DTranspose(2, 3),
             "DepthwiseConv2D": lambda: keras.layers.DepthwiseConv2D(3),
             "SeparableConv2D": lambda: keras.layers.SeparableConv2D(2, 3),
             "UpSampling2D": lambda: keras.layers.UpSampling2D(2)}[layer]
    m = keras.Sequential([keras.Input((6, 6, 2)), build()])
    jax_from_tf_keras(m)                  # the JAX package converts it
    with pytest.raises(NotImplementedError, match="item 8"):
        from_tf_keras(m, device="cpu")


def test_interop_bridges_raise_and_device_rule(monkeypatch):
    import analytics_zoo_tpu_torch.interop as interop
    for name in ("TorchNet", "OnnxNet", "TFNet"):
        with pytest.raises(NotImplementedError, match="item 10"):
            getattr(interop, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, _ = _seq_dense(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_tf_keras(m)
