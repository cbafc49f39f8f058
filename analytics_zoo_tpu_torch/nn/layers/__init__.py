"""The port's layers, one module per family of the JAX package's
``nn/layers``.  The recurrent layers are exported here, as the JAX
package's ``nn/layers/__init__.py`` exports them."""

from analytics_zoo_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D, Highway, SimpleRNN,
    TimeDistributed)
