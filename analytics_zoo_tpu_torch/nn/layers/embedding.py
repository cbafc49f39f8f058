"""Embedding-family layers beyond the core ``Embedding`` — the JAX
package's ``nn/layers/embedding.py``: ``WordEmbedding`` (a GloVe-style
text file), ``SparseEmbedding`` (pooled lookups of padded id lists) and
``SparseDense`` (a dense layer over padded (indices, values) pairs).

"Sparse" inputs are dense padded id / value arrays, as in the JAX
package.  Every lookup has the JAX ``jnp.take`` semantics of the core
``Embedding`` (``core.lookup``): float ids truncate, ids in [-V, -1] wrap,
any other id gives a row of NaN, and no device-side assert fires.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.layers.core import lookup
from analytics_zoo_tpu_torch.nn.module import Layer, initializer, to_shape


class WordEmbedding(Layer):
    """Pretrained word embeddings, frozen by default (WordEmbedding.scala):
    ``embedding_file`` holds "<word> <v1> <v2> ..." lines, ``word_index``
    maps word -> 1-based id (default: the file's words in order); row 0
    and words missing from the file stay zero.  Trainable, the table is
    the parameter ``E`` (its tree ``{E}``); frozen, a buffer outside the
    tree (``{}``)."""

    def __init__(self, embedding_file: str,
                 word_index: Optional[Dict[str, int]] = None,
                 trainable: bool = False, input_length: Optional[int] = None,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.embedding_file = embedding_file
        self.word_index = word_index
        self.trainable = trainable
        self.input_length = input_length
        # the table's shape follows from the file alone
        self.ensure_built(self._declared_input_shape)

    @staticmethod
    def get_word_index(embedding_file: str) -> Dict[str, int]:
        """The file's vocabulary -> 1-based ids (getWordIndex)."""
        index = {}
        with open(embedding_file, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                index[line.rstrip("\n").split(" ", 1)[0]] = i + 1
        return index

    def _load(self) -> np.ndarray:
        vectors, dim = {}, None
        with open(self.embedding_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                vec = np.asarray(parts[1:], dtype=np.float32)
                dim = len(vec)
                vectors[parts[0]] = vec
        if dim is None:
            raise ValueError(f"empty embedding file {self.embedding_file}")
        word_index = self.word_index or \
            {w: i + 1 for i, w in enumerate(vectors)}
        table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        for w, i in word_index.items():
            if w in vectors:
                table[i] = vectors[w]
        return table

    def build(self, input_shape):
        table = torch.from_numpy(self._load()).to(dtypes.param_dtype())
        if self.trainable:
            self.E = nn.Parameter(table)
        else:
            self.register_buffer("E", table)
        self._table = table.clone()

    def reset_parameters(self, gen):
        self.E.copy_(self._table)

    def _tree(self) -> Dict:
        return {"E": self.E} if self.trainable else {}

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape) + (self.E.shape[1],)

    def forward(self, x):
        return lookup(self.E, x)


class SparseEmbedding(Layer):
    """Pooled embedding of padded id lists (SparseEmbedding.scala,
    ``tf.nn.embedding_lookup_sparse``): (B, L) ids, id 0 padding ->
    (B, output_dim), the ``combiner`` ("sum", "mean", "sqrtn") of the
    non-padding rows."""

    def __init__(self, input_dim, output_dim, combiner: str = "sum",
                 init="uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.combiner = combiner
        self.init_name = init
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        self.E = nn.Parameter(torch.empty(self.input_dim, self.output_dim))

    def reset_parameters(self, gen):
        self.E.copy_(initializer(self.init_name, gen, self.E.shape))

    def _tree(self) -> Dict:
        return {"E": self.E}

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape)[:-1] + (self.output_dim,)

    def forward(self, x):
        ids = x.to(torch.int32) if x.is_floating_point() else x
        mask = (ids > 0).to(self.E.dtype)
        summed = (lookup(self.E, x) * mask[..., None]).sum(1)
        if self.combiner == "sum":
            return summed
        count = torch.clamp_min(mask.sum(1, keepdim=True), 1.0)
        if self.combiner == "mean":
            return summed / count
        if self.combiner == "sqrtn":
            return summed / torch.sqrt(count)
        raise ValueError(f"unknown combiner {self.combiner!r}")


class SparseDense(Layer):
    """A dense layer over sparse rows (SparseDense.scala): the input is a
    pair (indices (B, K) int column ids, values (B, K)), an index < 0
    ignored, and ``y[b] = Σ_k values[b, k] · W[indices[b, k]] + b`` — a
    gather and a weighted sum, never the (B, input_dim) dense matrix.
    ``W`` (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, activation=None, bias=True,
                 init="glorot_uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.activation = activations.get(activation)
        self.bias = bias
        self.init_name = init
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        self.W = nn.Parameter(torch.empty(self.input_dim, self.output_dim))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.output_dim))

    def reset_parameters(self, gen):
        self.W.copy_(initializer(self.init_name, gen, self.W.shape))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        return {"W": self.W, "b": self.b} if self.bias else {"W": self.W}

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape[0])[:-1] + (self.output_dim,)

    def forward(self, xs):
        indices, values = xs
        if indices.is_floating_point():
            indices = torch.nan_to_num(indices, nan=0.0).clamp(
                -2.0 ** 31, 2.0 ** 31).to(torch.int64)
        valid = indices >= 0
        rows = lookup(self.W, torch.where(valid, indices, 0))
        w, v = dtypes.cast_compute(rows, values * valid.to(values.dtype))
        y = (w * v[..., None]).sum(-2).to(dtypes.param_dtype())
        if self.bias:
            y = y + self.b
        return self.activation(y)
