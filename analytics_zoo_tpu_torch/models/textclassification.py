"""TextClassifier — CNN / LSTM / GRU text classification; the JAX
package's ``models/textclassification.py`` (``TextClassifier`` :23).

Reference parity: models/textclassification/TextClassifier.scala:34-192 —
token-id sequences → embedding → encoder (cnn: ``Convolution1D(k=5)`` +
``GlobalMaxPooling1D``; lstm / gru: the last state) → ``Dense(128,
relu)`` → ``Dense(class_num, softmax)``.  The reference loads GloVe into
the embedding; ``embedding_weights`` (vocab_size, embedding_dim) does the
same: it is installed over the drawn table at construction and again
after every ``init_weights``, as the JAX package installs it after its
``init_weights``.

Quantized (``InferenceModel.do_quantize``), the cnn encoder's int8 conv
runs the ``w8a8_conv2d`` kernel at a one-row geometry (the (1, 5)
convolution of (B, 1, T, embedding_dim)), and the two heads the ``w8a8``
/ ``w4a16`` kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.layers.conv import Convolution1D
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Embedding
from analytics_zoo_tpu_torch.nn.layers.pooling import GlobalMaxPooling1D
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM
from analytics_zoo_tpu_torch.nn.models import Sequential


class TextClassifier(ZooModel):
    def __init__(self, class_num: int, vocab_size: int,
                 embedding_dim: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 embedding_weights: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self.class_num = int(class_num)
        self.vocab_size = int(vocab_size)
        self.embedding_dim = int(embedding_dim)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.embedding_weights = None if embedding_weights is None else \
            np.asarray(embedding_weights, np.float32)
        super().__init__(device)
        self._install_embedding()

    def build_model(self) -> Sequential:
        m = Sequential(name="TextClassifier")
        m.add(Embedding(self.vocab_size, self.embedding_dim,
                        input_shape=(self.sequence_length,),
                        name="tc_embedding"))
        if self.encoder == "cnn":
            m.add(Convolution1D(self.encoder_output_dim, 5,
                                activation="relu", name="tc_conv"))
            m.add(GlobalMaxPooling1D(name="tc_pool"))
        elif self.encoder == "lstm":
            m.add(LSTM(self.encoder_output_dim, name="tc_lstm"))
        elif self.encoder == "gru":
            m.add(GRU(self.encoder_output_dim, name="tc_gru"))
        else:
            raise ValueError(f"unknown encoder {self.encoder!r} "
                             "(expected cnn/lstm/gru)")
        m.add(Dense(128, activation="relu", name="tc_fc"))
        m.add(Dense(self.class_num, activation="softmax", name="tc_out"))
        return m

    @torch.no_grad()
    def _install_embedding(self) -> None:
        if self.embedding_weights is not None:
            self.model.layers_list[0].E.copy_(
                torch.from_numpy(self.embedding_weights))

    def init_weights(self, seed: int = 0):
        self.model.init_weights(seed)
        self._install_embedding()
        return self.model
