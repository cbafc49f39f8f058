"""KNRM — kernel-pooling neural ranking, and the ranking metrics; the JAX
package's ``models/textmatching.py`` (``KNRM`` :23, ``evaluate_ndcg``
:89, ``evaluate_map`` :108).

Reference parity: models/textmatching/KNRM.scala:60-192 — query / doc
token ids → shared embedding → cosine translation matrix → RBF kernel
pooling (``kernel_num`` gaussian kernels over [-1, 1], the last at μ = 1
with ``exact_sigma``) → log-sum pooling over the query axis → ``Dense(1)``
(sigmoid in ``ranking`` mode).  Ranking metrics over grouped relations
follow models/common/Ranker.scala:1-175.

The JAX ``Lambda`` takes a jnp function; the port's takes a torch one
(by design), so the kernel pooling is ``cosine_pool`` here, in f32.  It
has no weights: the param tree is the JAX package's, ``{knrm_embed: {E},
knrm_kernels: {}, knrm_out: {W, b}}``.  Quantized, the head is the
``w8a8`` / ``w4a16`` kernels at K = ``kernel_num``, N = 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Embedding, Lambda
from analytics_zoo_tpu_torch.nn.models import Model


class KNRM(ZooModel):
    def __init__(self, text1_length: int, text2_length: int, vocab_size: int,
                 embed_size: int = 300, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking",
                 embedding_weights: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self.text1_length = int(text1_length)   # query
        self.text2_length = int(text2_length)   # doc
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        self.target_mode = target_mode
        self.embedding_weights = None if embedding_weights is None else \
            np.asarray(embedding_weights, np.float32)
        super().__init__(device)
        self._install_embedding()

    def _kernel_pool(self, sim):
        """sim (B, Tq, Td) cosine matrix -> (B, kernel_num) log-kernel
        pooled."""
        K = self.kernel_num
        feats = []
        for i in range(K):
            mu = 1.0 / (K - 1) + (2.0 * i) / (K - 1) - 1.0
            sig = self.exact_sigma if mu > 1.0 - 1e-6 else self.sigma
            mu = min(mu, 1.0)
            k = torch.exp(-((sim - mu) ** 2) / (2.0 * sig * sig))
            kq = torch.log1p(k.sum(dim=2)) * 0.5   # (B, Tq); the ref's 0.5
            feats.append(kq.sum(dim=1))
        return torch.stack(feats, dim=1)

    def cosine_pool(self, xs):
        """The ``Lambda``: cosine similarity of every query and doc
        embedding, then the kernel pooling."""
        a, b = (x.to(torch.float32) for x in xs)
        a = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        b = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return self._kernel_pool(torch.einsum("bqe,bde->bqd", a, b))

    def build_model(self) -> Model:
        q = Input(shape=(self.text1_length,), name="query")
        d = Input(shape=(self.text2_length,), name="doc")
        embed = Embedding(self.vocab_size, self.embed_size, name="knrm_embed")
        eq, ed = embed(q), embed(d)
        pooled = Lambda(self.cosine_pool, name="knrm_kernels")([eq, ed])
        out = Dense(1, activation="sigmoid"
                    if self.target_mode == "ranking" else None,
                    name="knrm_out")(pooled)
        return Model(input=[q, d], output=out, name="KNRM")

    @torch.no_grad()
    def _install_embedding(self) -> None:
        if self.embedding_weights is not None:
            self.model.graph_layers[0].E.copy_(
                torch.from_numpy(self.embedding_weights))

    def init_weights(self, seed: int = 0):
        self.model.init_weights(seed)
        self._install_embedding()
        return self.model


# -- Ranker evaluation (models/common/Ranker.scala) ---------------------------

def evaluate_ndcg(model, query_groups, k: int = 3, batch_size: int = 512):
    """query_groups: list of (q_ids (Tq,), docs (N, Td), labels (N,)).
    Returns mean NDCG@k over groups.  ``model`` is anything with
    ``predict([queries, docs], batch_size=)`` (a zoo model, its inner
    model, an ``InferenceModel``)."""
    scores = []
    for q, docs, labels in query_groups:
        n = docs.shape[0]
        qs = np.repeat(q[None, :], n, axis=0).astype(np.float32)
        pred = model.predict([qs, docs.astype(np.float32)],
                             batch_size=batch_size).reshape(-1)
        order = np.argsort(-pred)
        gains = (2.0 ** labels[order][:k] - 1.0) / np.log2(
            np.arange(2, min(k, n) + 2))
        ideal_order = np.argsort(-labels)
        ideal = (2.0 ** labels[ideal_order][:k] - 1.0) / np.log2(
            np.arange(2, min(k, n) + 2))
        scores.append(float(gains.sum() / ideal.sum())
                      if ideal.sum() > 0 else 0.0)
    return float(np.mean(scores))


def evaluate_map(model, query_groups, batch_size: int = 512):
    """Mean average precision over groups (binary labels)."""
    aps = []
    for q, docs, labels in query_groups:
        n = docs.shape[0]
        qs = np.repeat(q[None, :], n, axis=0).astype(np.float32)
        pred = model.predict([qs, docs.astype(np.float32)],
                             batch_size=batch_size).reshape(-1)
        order = np.argsort(-pred)
        rel = labels[order] > 0
        if rel.sum() == 0:
            aps.append(0.0)
            continue
        prec = np.cumsum(rel) / np.arange(1, n + 1)
        aps.append(float((prec * rel).sum() / rel.sum()))
    return float(np.mean(aps))
