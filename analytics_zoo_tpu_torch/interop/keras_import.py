"""tf.keras model import — structural conversion into the port's layers
and weights; the JAX package's ``interop/keras_import.py``.

Reference parity: TFPark's central capability — "bring a TF/Keras model, train it on the
zoo engine" (`TFOptimizer.from_keras` tf_optimizer.py:578-667, `KerasModel` model.py:
34-375).  Each tf.keras layer is converted to the equivalent port layer
and its trained weights are copied in the JAX package's param layout
(``utils/convert.load_jax_params``), so the model runs as plain PyTorch
(and the port's kernels where it quantizes) with no TF in the hot loop.

Sequential models convert layer by layer; FUNCTIONAL models through a
topological walk of the keras graph (KerasHistory edges) into the graph
DSL (``nn/graph.py``): multi-input/multi-output, shared layers and the
merge family (Add/Subtract/Multiply/Average/Maximum/Minimum/Concatenate).
LSTM and GRU in both ``reset_after`` modes import exactly (tf.keras's
gate orders are the port's).  ``Conv2DTranspose`` (its (kh, kw, out, in)
kernel is ``Deconvolution2D``'s ``W``), ``DepthwiseConv2D`` and
``SeparableConv2D`` (the (kh, kw, cin, mult) depthwise kernel as (kh,
kw, 1, cin·mult), output channel c·mult + m in both) and
``UpSampling2D`` convert as in the JAX importer; a dilated depthwise or
separable conv raises.  TensorFlow is imported only by ``from_tf_keras``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common.context import (DeviceLike,
                                                    resolve_device)
from analytics_zoo_tpu_torch.nn.graph import Input as GInput
from analytics_zoo_tpu_torch.nn.layers import conv as C
from analytics_zoo_tpu_torch.nn.layers import core as K
from analytics_zoo_tpu_torch.nn.layers import pooling as P
from analytics_zoo_tpu_torch.nn.layers import recurrent as R
from analytics_zoo_tpu_torch.nn.layers.attention import LayerNorm
from analytics_zoo_tpu_torch.nn.models import Model, Sequential
from analytics_zoo_tpu_torch.utils.convert import export_params, export_state

_MERGE_MODES = {"Add": "sum", "Subtract": "sub", "Multiply": "mul",
                "Average": "ave", "Maximum": "max", "Minimum": "min"}


def _require_unit_dilation(tl):
    rate = getattr(tl, "dilation_rate", 1)
    rates = rate if isinstance(rate, (tuple, list)) else (rate,)
    if any(int(r) != 1 for r in rates):
        raise NotImplementedError(
            f"{type(tl).__name__} with dilation_rate={rate}: the native "
            "depthwise/separable convs do not support dilation")


def _act_name(act) -> Optional[str]:
    name = getattr(act, "__name__", str(act))
    return None if name == "linear" else name


def _rnn_weights(tl, n: int):
    wts = tl.get_weights()
    if len(wts) < n:
        raise NotImplementedError(
            f"{type(tl).__name__} with use_bias=False has no native "
            "conversion (native RNN cells always carry a bias)")
    return wts


def _convert_layer(tl, **kw):
    """One tf.keras layer -> (native layer, weights dict | None,
    state dict | None).  Raises NotImplementedError for unsupported types."""
    cls = type(tl).__name__
    weights = state = None
    if cls == "Dense":
        layer = K.Dense(tl.units, activation=_act_name(tl.activation),
                        bias=tl.use_bias, **kw)
        weights = {"W": tl.kernel.numpy()}
        if tl.use_bias:
            weights["b"] = tl.bias.numpy()
    elif cls == "Conv2D":
        layer = C.Convolution2D(
            tl.filters, tl.kernel_size, activation=_act_name(tl.activation),
            border_mode=tl.padding, subsample=tl.strides,
            dilation=tl.dilation_rate, groups=getattr(tl, "groups", 1),
            bias=tl.use_bias, **kw)
        weights = {"W": tl.kernel.numpy()}
        if tl.use_bias:
            weights["b"] = tl.bias.numpy()
    elif cls == "Conv1D":
        layer = C.Convolution1D(
            tl.filters, tl.kernel_size[0],
            activation=_act_name(tl.activation), border_mode=tl.padding,
            subsample=tl.strides[0], dilation=tl.dilation_rate,
            bias=tl.use_bias, **kw)
        weights = {"W": tl.kernel.numpy()}
        if tl.use_bias:
            weights["b"] = tl.bias.numpy()
    elif cls == "Conv2DTranspose":
        layer = C.Deconvolution2D(
            tl.filters, tl.kernel_size, activation=_act_name(tl.activation),
            border_mode=tl.padding, subsample=tl.strides, bias=tl.use_bias,
            **kw)
        # tf kernel layout (kh, kw, out, in) == native Deconvolution2D W
        weights = {"W": tl.get_weights()[0]}
        if tl.use_bias:
            weights["b"] = tl.get_weights()[1]
    elif cls == "DepthwiseConv2D":
        _require_unit_dilation(tl)
        layer = C.DepthwiseConvolution2D(
            tl.kernel_size, depth_multiplier=tl.depth_multiplier,
            activation=_act_name(tl.activation), subsample=tl.strides,
            border_mode=tl.padding, bias=tl.use_bias, **kw)
        wts = tl.get_weights()
        kh, kw_, cin, mult = wts[0].shape
        weights = {"depthwise": wts[0].reshape(kh, kw_, 1, cin * mult)}
        if tl.use_bias:
            weights["b"] = wts[1]
    elif cls == "SeparableConv2D":
        _require_unit_dilation(tl)
        layer = C.SeparableConvolution2D(
            tl.filters, tl.kernel_size, depth_multiplier=tl.depth_multiplier,
            activation=_act_name(tl.activation), subsample=tl.strides,
            border_mode=tl.padding, bias=tl.use_bias, **kw)
        wts = tl.get_weights()
        kh, kw_, cin, mult = wts[0].shape
        weights = {"depthwise": wts[0].reshape(kh, kw_, 1, cin * mult),
                   "pointwise": wts[1]}
        if tl.use_bias:
            weights["b"] = wts[2]
    elif cls == "Embedding":
        layer = K.Embedding(tl.input_dim, tl.output_dim, **kw)
        weights = {"E": tl.embeddings.numpy()}
    elif cls == "BatchNormalization":
        ax = tl.axis if isinstance(tl.axis, int) else list(tl.axis)[0]
        rank = None
        try:
            rank = len(tl.input.shape)
        except Exception:
            pass
        if ax != -1 and (rank is None or ax != rank - 1):
            raise NotImplementedError(
                f"BatchNormalization axis={tl.axis}: only last-axis "
                "(channels_last) normalisation has a native conversion")
        layer = K.BatchNormalization(epsilon=tl.epsilon,
                                     momentum=tl.momentum, **kw)
        weights = {"gamma": tl.gamma.numpy(), "beta": tl.beta.numpy()}
        state = {"mean": tl.moving_mean.numpy(),
                 "var": tl.moving_variance.numpy()}
    elif cls == "LayerNormalization":
        axis = tl.axis if isinstance(tl.axis, int) else list(tl.axis)
        if axis not in (-1, [-1]):
            raise NotImplementedError(
                f"LayerNormalization axis {axis}: only last-axis supported")
        layer = LayerNorm(epsilon=tl.epsilon, **kw)
        weights = {"gamma": tl.gamma.numpy(), "beta": tl.beta.numpy()}
    elif cls == "LSTM":
        # tf gate order i,f,c,o == native order
        layer = R.LSTM(tl.units, activation=_act_name(tl.activation) or "tanh",
                       inner_activation=_act_name(tl.recurrent_activation)
                       or "sigmoid",
                       return_sequences=tl.return_sequences,
                       go_backwards=bool(getattr(tl, "go_backwards", False)),
                       **kw)
        wk, wr, b = _rnn_weights(tl, 3)
        weights = {"Wx": wk, "Wh": wr, "b": b}
    elif cls == "GRU":
        reset_after = bool(getattr(tl, "reset_after", False))
        layer = R.GRU(tl.units, reset_after=reset_after,
                      activation=_act_name(tl.activation) or "tanh",
                      inner_activation=_act_name(tl.recurrent_activation)
                      or "sigmoid",
                      return_sequences=tl.return_sequences,
                      go_backwards=bool(getattr(tl, "go_backwards", False)),
                      **kw)
        wts = _rnn_weights(tl, 3)
        if reset_after:
            # bias pair (2, 3H): input bias + recurrent bias, imported
            # EXACTLY into the native reset_after cell (round 5)
            wk, wr, bpair = wts
            if bpair.ndim == 2:
                weights = {"Wx": wk, "Wh": wr, "b": bpair[0], "br": bpair[1]}
            else:           # single fused bias: recurrent bias is zero
                weights = {"Wx": wk, "Wh": wr, "b": bpair,
                           "br": np.zeros_like(bpair)}
        else:
            wk, wr, b = wts
            weights = {"Wx": wk, "Wh": wr, "b": b}
    elif cls == "Dropout":
        layer = K.Dropout(tl.rate, **kw)
    elif cls == "Flatten":
        layer = K.Flatten(**kw)
    elif cls == "Activation":
        layer = K.Activation(_act_name(tl.activation) or "linear", **kw)
    elif cls == "MaxPooling2D":
        layer = P.MaxPooling2D(tl.pool_size, tl.strides,
                               border_mode=tl.padding, **kw)
    elif cls == "AveragePooling2D":
        layer = P.AveragePooling2D(tl.pool_size, tl.strides,
                                   border_mode=tl.padding, **kw)
    elif cls == "MaxPooling1D":
        layer = P.MaxPooling1D(tl.pool_size, tl.strides,
                               border_mode=tl.padding, **kw)
    elif cls == "GlobalMaxPooling1D":
        layer = P.GlobalMaxPooling1D(**kw)
    elif cls == "GlobalAveragePooling1D":
        layer = P.GlobalAveragePooling1D(**kw)
    elif cls == "GlobalMaxPooling2D":
        layer = P.GlobalMaxPooling2D(**kw)
    elif cls == "GlobalAveragePooling2D":
        layer = P.GlobalAveragePooling2D(**kw)
    elif cls == "Reshape":
        layer = K.Reshape(tl.target_shape, **kw)
    elif cls == "ZeroPadding2D":
        layer = C.ZeroPadding2D(tl.padding, **kw)
    elif cls == "UpSampling2D":
        layer = C.UpSampling2D(tl.size, **kw)
    elif cls in _MERGE_MODES:
        layer = K.Merge(mode=_MERGE_MODES[cls], **kw)
    elif cls == "Concatenate":
        layer = K.Merge(mode="concat", concat_axis=tl.axis, **kw)
    else:
        raise NotImplementedError(
            f"tf.keras layer {cls} has no native conversion yet (the "
            "JAX package's TFNet bridge is not ported: ROADMAP queue 1, "
            "item 10)")
    return layer, weights, state


def _materialize(model, weights_map, state_map):
    """Overwrite the model's own param and state trees with the imported
    tensors, leaf by leaf."""
    params, state = export_params(model), export_state(model)
    for lname, weights in weights_map.items():
        for k_, v in weights.items():
            params[lname][k_] = np.asarray(v)
    for lname, st in state_map.items():
        for k_, v in st.items():
            state[lname][k_] = np.asarray(v)
    model.set_weights(params, state)
    return model


def _from_sequential(tf_model) -> Sequential:
    model = Sequential(name=f"imported_{tf_model.name}")
    first_shape = tuple(tf_model.input_shape[1:])
    pending_input_shape = first_shape
    weights_map, state_map = {}, {}
    for tl in tf_model.layers:
        if type(tl).__name__ == "InputLayer":
            continue
        kw = {"name": "imp_" + tl.name}
        if pending_input_shape is not None:
            kw["input_shape"] = pending_input_shape
            pending_input_shape = None
        layer, weights, state = _convert_layer(tl, **kw)
        model.add(layer)
        if weights:
            weights_map[layer.name] = weights
        if state:
            state_map[layer.name] = state
    return _materialize(model, weights_map, state_map)


def _history_key(t):
    """KerasTensor -> (producing layer name, node index, tensor index);
    handles both keras-3 (operation) and keras-2 (layer) history tuples."""
    h = t._keras_history
    op = getattr(h, "operation", None)
    if op is None:
        op = h.layer if hasattr(h, "layer") else h[0]
    node_idx = h.node_index if hasattr(h, "node_index") else h[1]
    tensor_idx = h.tensor_index if hasattr(h, "tensor_index") else h[2]
    return (op.name, int(node_idx), int(tensor_idx))


def _from_functional(tf_model) -> Model:
    """Topological walk of a functional tf.keras graph into the native graph
    DSL (nn/graph.py).  Shared layers (multiple inbound nodes) become one
    native layer called per node — weight sharing by construction (params are
    keyed by layer name)."""

    sym = {}
    ins = []
    for t in tf_model.inputs:
        key = _history_key(t)
        s = GInput(shape=tuple(int(d) for d in t.shape[1:]),
                   name="imp_" + key[0])
        sym[key] = s
        ins.append(s)

    # Nodes belonging to THIS model's graph: a layer reused across several
    # tf models carries inbound nodes from all of them, and walking a
    # foreign node would reference tensors outside this graph.
    model_nodes = None
    by_depth = getattr(tf_model, "_nodes_by_depth", None)
    if by_depth:
        model_nodes = {id(n) for nodes in by_depth.values() for n in nodes}

    weights_map, state_map = {}, {}
    for tl in tf_model.layers:
        if type(tl).__name__ == "InputLayer":
            continue
        layer, weights, state = _convert_layer(tl, name="imp_" + tl.name)
        if weights:
            weights_map[layer.name] = weights
        if state:
            state_map[layer.name] = state
        for node_idx, node in enumerate(tl._inbound_nodes):
            if model_nodes is not None and id(node) not in model_nodes:
                continue
            keys = [_history_key(ti) for ti in node.input_tensors]
            if model_nodes is None and not all(k_ in sym for k_ in keys):
                continue    # foreign node (fallback when _nodes_by_depth
                            # is unavailable): its inputs aren't in this
                            # graph — same-model inputs always precede their
                            # consumers in the topological layer order
            node_ins = [sym[k_] for k_ in keys]
            out = layer(node_ins if len(node_ins) > 1 else node_ins[0])
            outs = out if isinstance(out, (list, tuple)) else [out]
            for oi, o in enumerate(outs):
                sym[(tl.name, node_idx, oi)] = o

    outs = [sym[_history_key(t)] for t in tf_model.outputs]
    model = Model(input=ins if len(ins) > 1 else ins[0],
                  output=outs if len(outs) > 1 else outs[0],
                  name=f"imported_{tf_model.name}")
    return _materialize(model, weights_map, state_map)


def from_tf_keras(tf_model, device: DeviceLike = None):
    """Convert a tf.keras model (Sequential OR functional) to the
    equivalent port model with identical weights, on ``device`` (the
    port's device rule).  Raises on unsupported layers."""
    import tensorflow as tf

    dev = resolve_device(device)
    if isinstance(tf_model, tf.keras.Sequential):
        return _from_sequential(tf_model).to(dev)
    return _from_functional(tf_model).to(dev)
