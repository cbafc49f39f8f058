"""NeuralCF — Neural Collaborative Filtering (GMF + MLP dual tower), the
JAX package's ``models/recommendation/neuralcf.py``.

Reference parity: models/recommendation/NeuralCF.scala:45-137 — user and
item id inputs, an MF tower (the elementwise product of two embeddings)
and an MLP tower (concatenated embeddings through a dense relu stack),
concatenated into a softmax head.  Ids are 1-based as in the reference
(tables sized count + 1).  The graph and its layer names are the JAX
package's, so its param tree loads as it is (``set_weights``).

In f32 the model is four gathers and four ``Dense`` products; quantized by
``InferenceModel.do_quantize`` the four ``Dense`` run the ``w8a8`` (int8)
or ``w4a16`` (int4) kernel of ``ops/quant_matmul.py`` on the card.
"""

from __future__ import annotations

from typing import Sequence

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.recommender import \
    Recommender
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.core import (Dense, Embedding,
                                                    Flatten, merge)
from analytics_zoo_tpu_torch.nn.models import Model


class NeuralCF(ZooModel, Recommender):
    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 device: DeviceLike = None):
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = tuple(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = int(mf_embed)
        super().__init__(device)

    def build_model(self) -> Model:
        user = Input(shape=(1,), name="user")
        item = Input(shape=(1,), name="item")

        mlp_u = Flatten(name="ncf_mlp_uflat")(
            Embedding(self.user_count + 1, self.user_embed,
                      name="ncf_mlp_user_embed")(user))
        mlp_i = Flatten(name="ncf_mlp_iflat")(
            Embedding(self.item_count + 1, self.item_embed,
                      name="ncf_mlp_item_embed")(item))
        h = merge([mlp_u, mlp_i], mode="concat", name="ncf_mlp_concat")
        for k, width in enumerate(self.hidden_layers):
            h = Dense(width, activation="relu", name=f"ncf_mlp_fc{k}")(h)

        if self.include_mf:
            mf_u = Flatten(name="ncf_mf_uflat")(
                Embedding(self.user_count + 1, self.mf_embed,
                          name="ncf_mf_user_embed")(user))
            mf_i = Flatten(name="ncf_mf_iflat")(
                Embedding(self.item_count + 1, self.mf_embed,
                          name="ncf_mf_item_embed")(item))
            mf = merge([mf_u, mf_i], mode="mul", name="ncf_mf_mul")
            h = merge([mf, h], mode="concat", name="ncf_concat")

        out = Dense(self.class_num, activation="softmax", name="ncf_out")(h)
        return Model(input=[user, item], output=out, name="NeuralCF")
