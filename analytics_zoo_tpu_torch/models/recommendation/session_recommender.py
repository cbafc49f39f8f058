"""SessionRecommender — GRU session-based recommendation, the JAX
package's ``models/recommendation/session_recommender.py``.

Reference parity: models/recommendation/SessionRecommender.scala:45-209 —
a session of item ids → item embedding → a GRU stack → ``Dense(item_count
+ 1)``; optionally (``include_history``) a purchase-history branch —
embedding, the mean over the history, a relu MLP, ``Dense(item_count +
1)`` — whose logits are summed into the session's; softmax over the item
vocabulary.  Ids are 1-based (tables sized count + 1) and fed as floats,
truncated by ``Embedding`` as the JAX lookup truncates them.  The graph
and its layer names are the JAX package's, so its param tree loads as it
is.

Quantized by ``InferenceModel.do_quantize``, the ``Dense`` layers (the
session head, and the history MLP and head) run the ``w8a8`` (int8) or
``w4a16`` (int4) kernel of ``ops/quant_matmul.py`` on the card; the GRU
gates stay f32 matmuls, as in the JAX package's quantizer.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.core import (Activation, Dense,
                                                    Embedding, Lambda, merge)
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU
from analytics_zoo_tpu_torch.nn.models import Model


def _mean_over_history(t):
    return t.mean(dim=1)


class SessionRecommender(ZooModel):
    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5, device: DeviceLike = None):
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = tuple(rnn_hidden_layers)
        self.session_length = int(session_length)
        self.include_history = include_history
        self.mlp_hidden_layers = tuple(mlp_hidden_layers)
        self.history_length = int(history_length)
        super().__init__(device)

    def build_model(self) -> Model:
        session = Input(shape=(self.session_length,), name="session_input")
        h = Embedding(self.item_count + 1, self.item_embed,
                      name="sr_item_embed")(session)
        for i, width in enumerate(self.rnn_hidden_layers):
            last = i == len(self.rnn_hidden_layers) - 1
            h = GRU(width, return_sequences=not last, name=f"sr_gru{i}")(h)
        rnn_logits = Dense(self.item_count + 1, name="sr_rnn_out")(h)
        inputs = [session]
        if self.include_history:
            hist = Input(shape=(self.history_length,), name="history_input")
            inputs.append(hist)
            m = Embedding(self.item_count + 1, self.item_embed,
                          name="sr_hist_embed")(hist)
            m = Lambda(_mean_over_history, name="sr_hist_mean")(m)
            for i, width in enumerate(self.mlp_hidden_layers):
                m = Dense(width, activation="relu", name=f"sr_mlp{i}")(m)
            mlp_logits = Dense(self.item_count + 1, name="sr_mlp_out")(m)
            logits = merge([rnn_logits, mlp_logits], mode="sum",
                           name="sr_sum")
        else:
            logits = rnn_logits
        out = Activation("softmax", name="sr_softmax")(logits)
        return Model(input=inputs, output=out, name="SessionRecommender")

    def recommend_for_session(self, sessions: np.ndarray, max_items: int = 5,
                              history: np.ndarray = None,
                              batch_size: int = 1024
                              ) -> List[List[Tuple[int, float]]]:
        """The ``max_items`` items of highest probability for each session,
        as ``(item, probability)`` pairs, best first (a stable argsort of
        the negated probabilities on the host, as in the JAX package)."""
        x = [np.asarray(sessions, np.float32)]
        if self.include_history:
            x.append(np.asarray(history, np.float32))
        probs = self.predict(x, batch_size=batch_size)
        out = []
        for row in probs:
            top = np.argsort(-row)[:max_items]
            out.append([(int(i), float(row[i])) for i in top])
        return out
