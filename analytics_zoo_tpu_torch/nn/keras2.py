"""Keras-2-style layer API — the JAX package's ``nn/keras2.py``: Keras-2
argument names over the port's layers.

Reference parity: pipeline/api/keras2/layers/*.scala (~20 layers with Keras-2 arg
names/aliases: `units` for output_dim, `kernel_initializer` for init, `rate` for p,
`filters`/`kernel_size`/`strides`/`padding` for conv, and merge-op classes
Add/Multiply/Average/Maximum/Minimum/Concatenate).  The merge classes
subclass ``core.Merge`` with its JAX signature.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.nn.layers import core as _core
from analytics_zoo_tpu_torch.nn.layers import conv as _conv
from analytics_zoo_tpu_torch.nn.layers import pooling as _pool


def _do(data_format):
    """keras2 data_format -> internal dim_ordering."""
    if data_format in ("channels_last", "tf", None):
        return "tf"
    if data_format in ("channels_first", "th"):
        return "th"
    raise ValueError(f"unknown data_format {data_format!r}")


def Dense(units, activation=None, kernel_initializer="glorot_uniform",
          use_bias=True, **kw):
    return _core.Dense(units, activation=activation, init=kernel_initializer,
                       bias=use_bias, **kw)


def Dropout(rate, **kw):
    return _core.Dropout(rate, **kw)


def Flatten(**kw):
    return _core.Flatten(**kw)


def Activation(activation, **kw):
    return _core.Activation(activation, **kw)


def Reshape(target_shape, **kw):
    return _core.Reshape(target_shape, **kw)


def Embedding(input_dim, output_dim, embeddings_initializer="uniform", **kw):
    return _core.Embedding(input_dim, output_dim, init=embeddings_initializer,
                           **kw)


def BatchNormalization(momentum=0.99, epsilon=1e-3, **kw):
    return _core.BatchNormalization(epsilon=epsilon, momentum=momentum, **kw)


def Conv1D(filters, kernel_size, strides=1, padding="valid", activation=None,
           kernel_initializer="glorot_uniform", use_bias=True,
           dilation_rate=1, **kw):
    return _conv.Convolution1D(filters, kernel_size, activation=activation,
                               border_mode=padding, subsample=strides,
                               dilation=dilation_rate,
                               init=kernel_initializer, bias=use_bias, **kw)


def Conv2D(filters, kernel_size, strides=1, padding="valid", activation=None,
           kernel_initializer="glorot_uniform", use_bias=True,
           dilation_rate=1, data_format="channels_last", groups=1, **kw):
    return _conv.Convolution2D(
        filters, kernel_size, activation=activation, border_mode=padding,
        subsample=strides, dilation=dilation_rate, init=kernel_initializer,
        bias=use_bias, groups=groups,
        dim_ordering=_do(data_format), **kw)


def DepthwiseConv2D(kernel_size, strides=1, padding="valid", activation=None,
                    depth_multiplier=1, depthwise_initializer="glorot_uniform",
                    use_bias=True, data_format="channels_last",
                    dilation_rate=1, **kw):
    if dilation_rate not in (1, (1, 1)):
        raise NotImplementedError(
            "DepthwiseConv2D dilation_rate != 1 is not supported")
    return _conv.DepthwiseConvolution2D(
        kernel_size, depth_multiplier=depth_multiplier, activation=activation,
        subsample=strides, border_mode=padding, init=depthwise_initializer,
        bias=use_bias, dim_ordering=_do(data_format), **kw)


def MaxPooling1D(pool_size=2, strides=None, padding="valid", **kw):
    return _pool.MaxPooling1D(pool_size, strides, border_mode=padding, **kw)


def MaxPooling2D(pool_size=2, strides=None, padding="valid",
                 data_format="channels_last", **kw):
    return _pool.MaxPooling2D(
        pool_size, strides, border_mode=padding,
        dim_ordering=_do(data_format), **kw)


def AveragePooling1D(pool_size=2, strides=None, padding="valid", **kw):
    return _pool.AveragePooling1D(pool_size, strides, border_mode=padding, **kw)


def AveragePooling2D(pool_size=2, strides=None, padding="valid",
                     data_format="channels_last", **kw):
    return _pool.AveragePooling2D(
        pool_size, strides, border_mode=padding,
        dim_ordering=_do(data_format), **kw)


def GlobalMaxPooling1D(**kw):
    return _pool.GlobalMaxPooling1D(**kw)


def GlobalAveragePooling2D(data_format="channels_last", **kw):
    return _pool.GlobalAveragePooling2D(
        dim_ordering=_do(data_format), **kw)


# -- merge-op classes (keras2/layers/merge) ----------------------------------

class Add(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="sum", **kw)


class Subtract(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="sub", **kw)


class Multiply(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="mul", **kw)


class Average(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="ave", **kw)


class Maximum(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="max", **kw)


class Minimum(_core.Merge):
    def __init__(self, **kw):
        super().__init__(mode="min", **kw)


class Concatenate(_core.Merge):
    def __init__(self, axis=-1, **kw):
        super().__init__(mode="concat", concat_axis=axis, **kw)


class Dot(_core.Merge):
    """Batched dot of two rank-2 (B, d) inputs along the feature axis;
    normalize=True gives cosine proximity (keras2/layers/merge Dot)."""

    def __init__(self, axes=1, normalize=False, **kw):
        if axes not in (1, -1):
            raise NotImplementedError(
                "Dot currently supports rank-2 inputs dotted along the "
                f"feature axis (axes=1); got axes={axes!r}")
        super().__init__(mode="cos" if normalize else "dot", **kw)

    def _merge(self, xs):
        if any(getattr(x, "ndim", 2) != 2 for x in xs):
            raise NotImplementedError(
                "Dot supports rank-2 (B, d) inputs only; got shapes "
                f"{[getattr(x, 'shape', None) for x in xs]}")
        return super()._merge(xs)


def add(inputs, **kw):
    return Add(**kw)(list(inputs))


def subtract(inputs, **kw):
    return Subtract(**kw)(list(inputs))


def multiply(inputs, **kw):
    return Multiply(**kw)(list(inputs))


def average(inputs, **kw):
    return Average(**kw)(list(inputs))


def maximum(inputs, **kw):
    return Maximum(**kw)(list(inputs))


def minimum(inputs, **kw):
    return Minimum(**kw)(list(inputs))


def concatenate(inputs, axis=-1, **kw):
    return Concatenate(axis=axis, **kw)(list(inputs))


def dot(inputs, normalize=False, **kw):
    return Dot(normalize=normalize, **kw)(list(inputs))


# -- further keras2 constructor aliases ---------------------------------------

def Conv3D(filters, kernel_size, strides=1, padding="valid", activation=None,
           kernel_initializer="glorot_uniform", use_bias=True,
           data_format="channels_last", **kw):
    return _conv.Convolution3D(filters, kernel_size, activation=activation,
                               border_mode=padding, subsample=strides,
                               init=kernel_initializer, bias=use_bias,
                               dim_ordering=_do(data_format), **kw)


def Conv2DTranspose(filters, kernel_size, strides=1, padding="valid",
                    activation=None, kernel_initializer="glorot_uniform",
                    use_bias=True, data_format="channels_last", **kw):
    return _conv.Deconvolution2D(filters, kernel_size, activation=activation,
                                 subsample=strides, border_mode=padding,
                                 init=kernel_initializer, bias=use_bias,
                                 dim_ordering=_do(data_format), **kw)


def SeparableConv2D(filters, kernel_size, strides=1, padding="valid",
                    depth_multiplier=1, activation=None, use_bias=True,
                    data_format="channels_last", **kw):
    return _conv.SeparableConvolution2D(
        filters, kernel_size, depth_multiplier=depth_multiplier,
        activation=activation, subsample=strides, border_mode=padding,
        bias=use_bias, dim_ordering=_do(data_format), **kw)


def MaxPooling3D(pool_size=2, strides=None, padding="valid",
                 data_format="channels_last", **kw):
    return _pool.MaxPooling3D(pool_size, strides=strides, border_mode=padding,
                              dim_ordering=_do(data_format), **kw)


def AveragePooling3D(pool_size=2, strides=None, padding="valid",
                     data_format="channels_last", **kw):
    return _pool.AveragePooling3D(pool_size, strides=strides,
                                  border_mode=padding,
                                  dim_ordering=_do(data_format), **kw)


def GlobalMaxPooling2D(data_format="channels_last", **kw):
    return _pool.GlobalMaxPooling2D(dim_ordering=_do(data_format), **kw)


def GlobalMaxPooling3D(data_format="channels_last", **kw):
    return _pool.GlobalMaxPooling3D(dim_ordering=_do(data_format), **kw)


def GlobalAveragePooling1D(data_format="channels_last", **kw):
    return _pool.GlobalAveragePooling1D(dim_ordering=_do(data_format), **kw)


def GlobalAveragePooling3D(data_format="channels_last", **kw):
    return _pool.GlobalAveragePooling3D(dim_ordering=_do(data_format), **kw)


def UpSampling2D(size=(2, 2), **kw):
    return _conv.UpSampling2D(size, **kw)


def ZeroPadding2D(padding=(1, 1), **kw):
    return _conv.ZeroPadding2D(padding, **kw)


def Cropping2D(cropping=((0, 0), (0, 0)), **kw):
    return _conv.Cropping2D(cropping, **kw)


def Cropping1D(cropping=(1, 1), **kw):
    return _conv.Cropping1D(cropping, **kw)


def LocallyConnected1D(filters, kernel_size, strides=1, padding="valid",
                       activation=None, use_bias=True,
                       kernel_initializer="glorot_uniform", **kw):
    if strides != 1 or padding != "valid":
        raise NotImplementedError(
            "LocallyConnected1D supports strides=1, padding='valid' "
            "(the reference keras2 layer's defaults)")
    return _conv.LocallyConnected1D(filters, kernel_size,
                                    activation=activation, bias=use_bias,
                                    init=kernel_initializer, **kw)


def Softmax(axis=-1, **kw):
    if axis != -1:
        raise NotImplementedError(
            "Softmax supports the last axis only (axis=-1); transpose the "
            f"input instead of axis={axis!r}")
    return _core.Activation("softmax", **kw)


def LSTM(units, activation="tanh", recurrent_activation="hard_sigmoid",
         return_sequences=False, go_backwards=False, **kw):
    from analytics_zoo_tpu_torch.nn.layers import recurrent as _rnn
    return _rnn.LSTM(units, activation=activation,
                     inner_activation=recurrent_activation,
                     return_sequences=return_sequences,
                     go_backwards=go_backwards, **kw)


def GRU(units, activation="tanh", recurrent_activation="hard_sigmoid",
        return_sequences=False, go_backwards=False, **kw):
    from analytics_zoo_tpu_torch.nn.layers import recurrent as _rnn
    return _rnn.GRU(units, activation=activation,
                    inner_activation=recurrent_activation,
                    return_sequences=return_sequences,
                    go_backwards=go_backwards, **kw)


def SimpleRNN(units, activation="tanh", return_sequences=False,
              go_backwards=False, **kw):
    from analytics_zoo_tpu_torch.nn.layers import recurrent as _rnn
    return _rnn.SimpleRNN(units, activation=activation,
                          return_sequences=return_sequences,
                          go_backwards=go_backwards, **kw)
