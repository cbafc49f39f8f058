"""PyTorch port: the recurrent layers (``nn/layers/recurrent.py``) against
the JAX package's on the CPU.

The same seeded numpy weights (the JAX layer's ``build``, every leaf
moved off its initial value so that biases count) and inputs go through
the JAX layer and the port's, the weights carried across by
``load_jax_params``.  Outputs, the input's gradient and every parameter's
gradient of ``sum(y * cot)`` (``jax.grad`` against autograd) agree within
TOL = 1e-5: the same f32 math in another summation order (the port
computes the input projection for all steps in one matmul), read at
~1e-7.

- ``SimpleRNN``, ``LSTM`` and ``GRU`` in both reset conventions, each with
  ``go_backwards`` x ``return_sequences``;
- ``Bidirectional`` in all four merge modes;
- ``TimeDistributed(Dense)``, and ``TimeDistributed(BatchNormalization)``
  in training mode with its state (the moving statistics after the step);
- ``Highway``;
- ``ConvLSTM2D`` and ``ConvLSTM3D`` with odd and even kernels under
  ``same`` and ``valid`` (XLA's SAME pads an even kernel more at the end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import recurrent as jrec
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.nn import layers as tlayers
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import recurrent as trec
from analytics_zoo_tpu_torch.nn.module import Layer
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   export_state,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
B, T, D, H = 3, 6, 4, 5


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v.detach().cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


def _grads(layer: Layer):
    """The port layer's parameter gradients laid out as its param tree."""
    def walk(v):
        if isinstance(v, Layer):
            return walk(v._tree())
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v.grad
    return walk(layer)


def _jitter(params, seed):
    """Every leaf moved by N(0, 0.1²): zero biases and the Highway's -2
    would leave their terms untested."""
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * g.standard_normal(np.shape(a)))
        .astype(np.float32), params)


def _check(jlayer, tlayer, in_shape, seed=0, training=False):
    """Forward and gradients of the two layers on one seeded input;
    returns the JAX state after the call and the port layer."""
    g = np.random.default_rng(seed + 100)
    params = _jitter(_np(jlayer.build(jax.random.PRNGKey(seed), in_shape)),
                     seed)
    state = jlayer.init_state(in_shape)
    x = g.standard_normal((B,) + tuple(in_shape)).astype(np.float32)
    load_jax_params(tlayer, params)
    tlayer.train(training)

    def fn(p, xx):
        y, st = jlayer.apply(p, state, xx, training=training)
        return y, st

    y_j, st_j = fn(params, x)
    cot = g.standard_normal(np.shape(y_j)).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(fn(p, xx)[0] * cot),
                      argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tlayer(xt)
    (y_t * torch.from_numpy(cot)).sum().backward()
    assert tuple(y_t.shape) == np.shape(y_j)
    assert tuple(y_t.shape[1:]) == tuple(
        tlayer.compute_output_shape(in_shape))
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=TOL, rtol=TOL)
    want, got = _flat(_np(gp)), _flat(_grads(tlayer))
    assert sorted(got) == sorted(want) and want
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL,
                                   rtol=TOL, err_msg=path)
    return st_j, tlayer


RNNS = {
    "simple_rnn": (jrec.SimpleRNN, trec.SimpleRNN, {}),
    "lstm": (jrec.LSTM, trec.LSTM, {}),
    "gru": (jrec.GRU, trec.GRU, {}),
    "gru_reset_after": (jrec.GRU, trec.GRU, {"reset_after": True}),
}


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("kind", sorted(RNNS))
def test_rnn_layer_matches_jax(kind, go_backwards, return_sequences):
    jcls, tcls, kw = RNNS[kind]
    kw = dict(kw, go_backwards=go_backwards,
              return_sequences=return_sequences)
    _, tl = _check(jcls(H, **kw), tcls(H, input_shape=(T, D), **kw),
                   (T, D), seed=len(kind))
    assert sorted(tl._tree()) == sorted(
        ["Wx", "Wh", "b"] + (["br"] if kw.get("reset_after") else []))


def test_rnn_trees_and_shapes():
    """The trees' leaves and shapes, the hard_sigmoid default, and the
    layers' export from ``nn/layers``."""
    gru = tlayers.GRU(H, reset_after=True, input_shape=(T, D))
    tree = export_params(gru)
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        "Wx": (D, 3 * H), "Wh": (H, 3 * H), "b": (3 * H,),
        "br": (3 * H,)}
    lstm = tlayers.LSTM(H, return_sequences=True, input_shape=(T, D))
    assert lstm.compute_output_shape((T, D)) == (T, H)
    assert tuple(lstm.Wx.shape) == (D, 4 * H)
    x = torch.tensor([-3.0, -2.5, 0.0, 2.5, 3.0])
    assert lstm.inner_activation(x).tolist() == [0.0, 0.0, 0.5, 1.0, 1.0]
    for name in ("SimpleRNN", "LSTM", "GRU", "Bidirectional",
                 "TimeDistributed", "ConvLSTM2D", "ConvLSTM3D", "Highway"):
        assert getattr(tlayers, name) is getattr(trec, name)


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_jax(merge_mode, return_sequences):
    """The backward copy is named ``<name>_bwd`` and runs with
    ``go_backwards`` flipped; the tree is ``{fwd, bwd}``."""
    jl = jrec.Bidirectional(jrec.LSTM(H, return_sequences=return_sequences,
                                      name="enc"), merge_mode=merge_mode)
    tl = trec.Bidirectional(trec.LSTM(H, return_sequences=return_sequences,
                                      name="enc"), merge_mode=merge_mode,
                            input_shape=(T, D))
    _check(jl, tl, (T, D), seed=7)
    assert tl.backward_layer.name == "enc_bwd"
    assert tl.backward_layer.go_backwards and \
        not tl.forward_layer.go_backwards
    assert sorted(tl._tree()) == ["bwd", "fwd"]


def test_bidirectional_copy_of_a_built_layer_draws_its_own_weights():
    inner = trec.GRU(H, input_shape=(T, D), name="g")
    bi = trec.Bidirectional(inner)
    assert not torch.equal(bi.forward_layer.Wx, bi.backward_layer.Wx)
    with pytest.raises(ValueError):
        trec.Bidirectional(trec.GRU(H), merge_mode="max")


def test_time_distributed_dense_matches_jax():
    _check(jrec.TimeDistributed(jcore.Dense(H)),
           trec.TimeDistributed(tcore.Dense(H), input_shape=(T, D)),
           (T, D), seed=3)


def test_time_distributed_batchnorm_state_matches_jax():
    """Training mode: the batch statistics over all B·T rows normalise the
    output, and the moving statistics the step leaves in the inner layer's
    buffers equal the JAX state ``{inner: {mean, var}}``."""
    st_j, tl = _check(
        jrec.TimeDistributed(jcore.BatchNormalization()),
        trec.TimeDistributed(tcore.BatchNormalization(), input_shape=(T, D)),
        (T, D), seed=4, training=True)
    want, got = _flat(_np(st_j)), _flat(export_state(tl))
    assert sorted(got) == sorted(want) == ["inner/mean", "inner/var"]
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL,
                                   rtol=TOL, err_msg=path)


@pytest.mark.parametrize("bias", [True, False])
def test_highway_matches_jax(bias):
    _check(jrec.Highway(bias=bias), trec.Highway(bias=bias, input_shape=(D,)),
           (D,), seed=5)


@pytest.mark.parametrize("border_mode", ["same", "valid"])
@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_lstm_matches_jax(ndim, k, border_mode):
    """Channels-last input; ``border_mode`` on the input convolution only,
    the recurrent one SAME (an even kernel padded more at the end, as
    XLA's SAME pads it).  The sequence output in one of the cases of
    each rank."""
    jcls = jrec.ConvLSTM2D if ndim == 2 else jrec.ConvLSTM3D
    tcls = trec.ConvLSTM2D if ndim == 2 else trec.ConvLSTM3D
    spatial = (5, 6) if ndim == 2 else (4, 5, 3)
    shape = (3,) + spatial + (2,)
    seq = k == 2 and border_mode == "valid"
    _check(jcls(3, k, return_sequences=seq, border_mode=border_mode),
           tcls(3, k, return_sequences=seq, border_mode=border_mode,
                input_shape=shape), shape, seed=ndim * 10 + k)


def test_conv_lstm_tree_is_the_jax_layout():
    cl = trec.ConvLSTM2D(4, 3, input_shape=(2, 5, 5, 3))
    assert {k: tuple(v.shape) for k, v in export_params(cl).items()} == {
        "Wx": (3, 3, 3, 16), "Wh": (3, 3, 4, 16), "b": (16,)}
    assert cl.compute_output_shape((2, 5, 5, 3)) == (5, 5, 4)
    assert trec.ConvLSTM2D(4, 3, border_mode="valid", return_sequences=True,
                           input_shape=(2, 5, 5, 3)).compute_output_shape(
        (2, 5, 5, 3)) == (2, 3, 3, 4)
