"""The port's layers, one module per family of the JAX package's
``nn/layers``, exported here as the JAX package's ``nn/layers/__init__.py``
exports them."""

from analytics_zoo_tpu_torch.nn.layers.core import (  # noqa: F401
    Activation, BatchNormalization, Dense, Dropout, Embedding, ExpandDim,
    Flatten, GaussianDropout, GaussianNoise, InputLayer, Lambda, Masking,
    Merge, Narrow, Permute, RepeatVector, Reshape, Select, Squeeze, merge)
from analytics_zoo_tpu_torch.nn.layers.conv import (  # noqa: F401
    AtrousConvolution1D, AtrousConvolution2D, Convolution1D, Convolution2D,
    Convolution3D, Cropping1D, Cropping2D, Cropping3D, Deconvolution2D,
    DepthwiseConvolution2D, LocallyConnected1D, LocallyConnected2D, LRN2D,
    ResizeBilinear,
    SeparableConvolution2D, ShareConvolution2D, SpaceToDepth, UpSampling1D,
    UpSampling2D, UpSampling3D, ZeroPadding1D, ZeroPadding2D, ZeroPadding3D)
from analytics_zoo_tpu_torch.nn.layers.pooling import (  # noqa: F401
    AveragePooling1D, AveragePooling2D, AveragePooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D,
    MaxPooling1D, MaxPooling2D, MaxPooling3D)
from analytics_zoo_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D, Highway, SimpleRNN,
    TimeDistributed)
from analytics_zoo_tpu_torch.nn.layers.math import (  # noqa: F401
    AddConstant, BinaryThreshold, CAdd, CMul, Exp, Expand, GaussianSampler,
    GetShape, HardShrink, HardTanh, Identity, Log, Max, Mul, MulConstant,
    Negative, Power, RReLU, Scale, SelectTable, Softmax, SoftShrink,
    SplitTensor, Sqrt, Square, Threshold)
from analytics_zoo_tpu_torch.nn.layers.embedding import (  # noqa: F401
    SparseDense, SparseEmbedding, WordEmbedding)
from analytics_zoo_tpu_torch.nn.layers.crf import CRF  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers.moe import (  # noqa: F401
    MixtureOfExperts)
from analytics_zoo_tpu_torch.nn.layers.advanced import (  # noqa: F401
    ELU, LeakyReLU, MaxoutDense, PReLU, SReLU, SpatialDropout1D,
    SpatialDropout2D, ThresholdedReLU, WithinChannelLRN2D)
from analytics_zoo_tpu_torch.nn.layers.attention import (  # noqa: F401
    BERT, LayerNorm, MultiHeadAttention, PositionwiseFFN, TransformerBlock,
    TransformerLayer)
