"""The port's layers, one module per family of the JAX package's
``nn/layers``, exported here as the JAX package's ``nn/layers/__init__.py``
exports them (the layers the port has; ``tests/test_torch_port_imports.py``
lists the rest)."""

from analytics_zoo_tpu_torch.nn.layers.core import (  # noqa: F401
    Activation, BatchNormalization, Dense, Dropout, Embedding, ExpandDim,
    Flatten, GaussianDropout, GaussianNoise, InputLayer, Lambda, Masking,
    Merge, Narrow, Permute, RepeatVector, Reshape, Select, Squeeze, merge)
from analytics_zoo_tpu_torch.nn.layers.conv import (  # noqa: F401
    AtrousConvolution1D, Convolution1D, Convolution2D, SpaceToDepth,
    ZeroPadding2D)
from analytics_zoo_tpu_torch.nn.layers.pooling import (  # noqa: F401
    AveragePooling1D, AveragePooling2D, GlobalAveragePooling1D,
    GlobalAveragePooling2D, GlobalMaxPooling1D, GlobalMaxPooling2D,
    MaxPooling1D, MaxPooling2D)
from analytics_zoo_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D, Highway, SimpleRNN,
    TimeDistributed)
from analytics_zoo_tpu_torch.nn.layers.crf import CRF  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers.attention import (  # noqa: F401
    BERT, LayerNorm, MultiHeadAttention, PositionwiseFFN, TransformerBlock,
    TransformerLayer)
