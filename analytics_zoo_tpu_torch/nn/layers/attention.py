"""Transformer/BERT layers — the JAX package's ``nn/layers/attention.py``.

``TransformerLayer`` (GPT-style blocks over token ids, causal unless
``bidirectional``) and ``BERT`` (word + position + token-type embeddings,
post-LN encoder blocks, attention-mask input).  Attention runs through
``ops/attention.attention_bthd``: on the card an unmasked call takes the
hand-written flash kernel, reading q/k/v straight from the fused qkv
projection's (B, T, heads, D) layout; BERT's masked calls take the plain
path, as in the JAX package.

Parameters keep the JAX tree layout (``_tree``): ``wte``/``wpe`` and one
subtree per block, keyed ``<layer name>_block<i>``, holding ``attn``
(``qkv``, ``out``), ``ffn`` (``fc``, ``proj``), ``ln1`` and ``ln2``;
every dense is ``{W (d_in, d_out), b}``, every LayerNorm ``{gamma, beta}``.

Token ids out of range behave as ``jnp.take`` does: ids in [-V, 0) wrap,
any other out-of-range id gives a NaN embedding row (no device-side
assert, no host sync).  In training mode (``train()``, with seeds from
``Layer.seed_dropout``) ``embedding_drop`` and ``resid_drop`` apply
inverted dropout, and ``attn_drop`` sends attention through the einsum
path with the layer's generator; at the JAX defaults (all 0) training
keeps the flash kernels, forward and backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.module import (Layer, dropout, generator,
                                               to_shape)
from analytics_zoo_tpu_torch.ops.attention import attention_bthd


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: negative ids wrap, out-of-range
    ids give NaN rows."""
    n = table.shape[0]
    ok = (ids >= -n) & (ids < n)
    rows = table[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]
    return torch.where(ok[..., None], rows, float("nan"))


def _ids(x) -> torch.Tensor:
    ids = torch.as_tensor(x).to(torch.long)
    return ids[..., 0] if ids.ndim == 3 else ids


class LayerNorm(Layer):
    """Layer normalization over the last axis (population variance)."""

    def __init__(self, epsilon=1e-5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.epsilon = float(epsilon)
        self._build_declared()

    def build(self, input_shape):
        d = to_shape(input_shape)[-1]
        self.gamma = nn.Parameter(torch.ones(d))
        self.beta = nn.Parameter(torch.zeros(d))

    def reset_parameters(self, gen):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def _tree(self):
        return {"gamma": self.gamma, "beta": self.beta}

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + self.epsilon)
        return y * self.gamma + self.beta


class _Linear(nn.Module):
    """One ``{W (d_in, d_out), b}`` dense of an attention layer."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def reset(self, gen, std: float) -> None:
        self.W.copy_(std * torch.randn(self.W.shape, generator=gen))
        self.b.zero_()

    def tree(self):
        return {"W": self.W, "b": self.b}


def _linear(p: _Linear, x):
    xw, W = dtypes.cast_compute(x, p.W)
    return dtypes.matmul(xw, W, torch.float32) + p.b


class MultiHeadAttention(Layer):
    """Self-attention with a fused qkv projection.  Input (B, T, H)."""

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 attn_drop: float = 0.0, resid_drop: float = 0.0,
                 initializer_range: float = 0.02, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        if hidden_size % n_head:
            raise ValueError(f"hidden_size={hidden_size} not divisible by "
                             f"n_head={n_head}")
        self.hidden_size = int(hidden_size)
        self.n_head = int(n_head)
        self.causal = causal
        self.attn_drop = float(attn_drop)
        self.resid_drop = float(resid_drop)
        self.std = initializer_range
        # the flash kernel or its plain version (ops/_impl.resolve_impl)
        self.impl: Optional[str] = None
        self.ensure_built(input_shape)

    def build(self, input_shape):
        h = self.hidden_size
        self.qkv = _Linear(h, 3 * h)
        self.out = _Linear(h, h)

    def reset_parameters(self, gen):
        self.qkv.reset(gen, self.std)
        self.out.reset(gen, self.std)

    def _tree(self):
        return {"qkv": self.qkv.tree(), "out": self.out.tree()}

    def attend(self, x, mask=None):
        B, T, H = x.shape
        nh, hd = self.n_head, H // self.n_head
        qkv = _linear(self.qkv, x)                            # (B, T, 3H)
        # views in the (B, T, heads, D) layout: no copy, the flash kernel
        # reads them through their strides
        q, k, v = (t.unflatten(-1, (nh, hd))
                   for t in qkv.split(H, dim=-1))
        # the JAX split(rng) into the attention and residual keys
        attn_seed, resid_seed = self.train_seed(0), self.train_seed(1)
        attn_gen, rate = None, 0.0
        if attn_seed is not None and self.attn_drop > 0.0:
            attn_gen, rate = generator(attn_seed, x.device), self.attn_drop
        y = attention_bthd(q, k, v, mask=mask, causal=self.causal,
                           dropout_rate=rate, dropout_rng=attn_gen,
                           impl=self.impl)
        y = _linear(self.out, y.reshape(B, T, H))
        if resid_seed is not None and self.resid_drop > 0.0:
            y = dropout(y, self.resid_drop, resid_seed)
        return y

    def forward(self, x):
        return self.attend(x)


class PositionwiseFFN(Layer):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation="gelu", initializer_range=0.02,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.h = int(hidden_size)
        self.i = int(intermediate_size)
        self.act = activations.get(activation)
        self.std = initializer_range
        self.ensure_built(input_shape)

    def build(self, input_shape):
        self.fc = _Linear(self.h, self.i)
        self.proj = _Linear(self.i, self.h)

    def reset_parameters(self, gen):
        self.fc.reset(gen, self.std)
        self.proj.reset(gen, self.std)

    def _tree(self):
        return {"fc": self.fc.tree(), "proj": self.proj.tree()}

    def forward(self, x):
        return _linear(self.proj, self.act(_linear(self.fc, x)))


class TransformerBlock(Layer):
    """Post-LN transformer block (TransformerLayer.scala ``block``)."""

    def __init__(self, hidden_size: int, n_head: int, intermediate_size=None,
                 causal=False, attn_drop=0.0, resid_drop=0.0,
                 activation="gelu", initializer_range=0.02,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        inter = intermediate_size or 4 * hidden_size
        self.attn = MultiHeadAttention(hidden_size, n_head, causal=causal,
                                       attn_drop=attn_drop,
                                       resid_drop=resid_drop,
                                       initializer_range=initializer_range,
                                       name=self.name + "_attn")
        self.ffn = PositionwiseFFN(hidden_size, inter, activation=activation,
                                   initializer_range=initializer_range,
                                   name=self.name + "_ffn")
        self.ln1 = LayerNorm(input_shape=(hidden_size,),
                             name=self.name + "_ln1")
        self.ln2 = LayerNorm(input_shape=(hidden_size,),
                             name=self.name + "_ln2")
        self.built = True

    def reset_parameters(self, gen):
        for sub in (self.attn, self.ffn, self.ln1, self.ln2):
            sub.reset_parameters(gen)

    def _tree(self):
        return {"attn": self.attn, "ffn": self.ffn, "ln1": self.ln1,
                "ln2": self.ln2}

    def forward(self, x, mask=None):
        a = self.attn.attend(x, mask=mask)
        x = self.ln1(x + a)
        return self.ln2(x + self.ffn(x))


class TransformerLayer(Layer):
    """GPT-style transformer over token ids (TransformerLayer.scala:56-279).

    Input (B, T) ids (a trailing unit axis is dropped); output (B, T,
    hidden), or (B, n_block, T, hidden) with ``output_all_block``.
    ``bidirectional=False`` applies the causal mask."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, seq_len: int = 512, embedding_drop=0.0,
                 attn_drop=0.0, resid_drop=0.0, bidirectional=False,
                 initializer_range=0.02, output_all_block=False,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.vocab = int(vocab)
        self.hidden_size = int(hidden_size)
        self.n_block = int(n_block)
        self.seq_len = int(seq_len)
        self.embedding_drop = float(embedding_drop)
        self.bidirectional = bidirectional
        self.output_all_block = output_all_block
        self.std = initializer_range
        self.blocks = nn.ModuleList(
            [TransformerBlock(hidden_size, n_head, causal=not bidirectional,
                              attn_drop=attn_drop, resid_drop=resid_drop,
                              initializer_range=initializer_range,
                              name=f"{self.name}_block{i}")
             for i in range(self.n_block)])
        self.ensure_built(input_shape)

    def build(self, input_shape):
        H = self.hidden_size
        self.wte = nn.Parameter(torch.empty(self.vocab, H))
        self.wpe = nn.Parameter(torch.empty(self.seq_len, H))

    def reset_parameters(self, gen):
        self.wte.copy_(self.std * torch.randn(self.wte.shape, generator=gen))
        self.wpe.copy_(self.std * torch.randn(self.wpe.shape, generator=gen))
        for blk in self.blocks:
            blk.reset_parameters(gen)

    def _tree(self):
        tree = {"wte": self.wte, "wpe": self.wpe}
        tree.update((blk.name, blk) for blk in self.blocks)
        return tree

    def compute_output_shape(self, input_shape):
        T = to_shape(input_shape)[0]
        H = self.hidden_size
        return (self.n_block, T, H) if self.output_all_block else (T, H)

    def forward(self, x):
        ids = _ids(x).to(self.wte.device)
        T = ids.shape[1]
        if T > self.seq_len:
            raise ValueError(f"{self.name}: {T} tokens exceed seq_len="
                             f"{self.seq_len}")
        h = _take(self.wte, ids) + self.wpe[:T]
        emb_seed = self.train_seed(999)
        if emb_seed is not None and self.embedding_drop > 0.0:
            h = dropout(h, self.embedding_drop, emb_seed)
        outs = []
        for blk in self.blocks:
            h = blk(h)
            outs.append(h)
        if self.output_all_block:
            return torch.stack(outs, dim=1)
        return h


class BERT(Layer):
    """BERT encoder (BERT.scala:66-402).

    Inputs: ``[token_ids (B, T), token_type_ids (B, T), attention_mask
    (B, T)]`` (the last two optional); position ids are implicit 0..T-1.
    Output: sequence states (B, T, H); ``pooled()`` gives the first-token
    classification features."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, max_position_len: int = 512,
                 intermediate_size: int = 3072, hidden_drop=0.1,
                 attn_drop=0.1, initializer_range=0.02,
                 output_all_block=False, type_vocab: int = 2,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.vocab = int(vocab)
        self.hidden_size = int(hidden_size)
        self.n_block = int(n_block)
        self.max_position_len = int(max_position_len)
        self.type_vocab = int(type_vocab)
        self.std = initializer_range
        self.output_all_block = output_all_block
        self.blocks = nn.ModuleList(
            [TransformerBlock(hidden_size, n_head,
                              intermediate_size=intermediate_size,
                              causal=False, attn_drop=attn_drop,
                              resid_drop=hidden_drop,
                              initializer_range=initializer_range,
                              name=f"{self.name}_block{i}")
             for i in range(self.n_block)])
        self.emb_ln = LayerNorm(input_shape=(hidden_size,),
                                name=self.name + "_embln")
        self.ensure_built(input_shape)

    def build(self, input_shape):
        H = self.hidden_size
        self.word = nn.Parameter(torch.empty(self.vocab, H))
        self.pos = nn.Parameter(torch.empty(self.max_position_len, H))
        # ``type`` names nn.Module.type(): the tree key stays "type"
        self.type_emb = nn.Parameter(torch.empty(self.type_vocab, H))
        self.pooler = _Linear(H, H)

    def reset_parameters(self, gen):
        for p in (self.word, self.pos, self.type_emb):
            p.copy_(self.std * torch.randn(p.shape, generator=gen))
        self.emb_ln.reset_parameters(gen)
        self.pooler.reset(gen, self.std)
        for blk in self.blocks:
            blk.reset_parameters(gen)

    def _tree(self):
        tree = {"word": self.word, "pos": self.pos, "type": self.type_emb,
                "embln": self.emb_ln, "pooler": self.pooler.tree()}
        tree.update((blk.name, blk) for blk in self.blocks)
        return tree

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        T = to_shape(shapes[0])[0]
        H = self.hidden_size
        return (self.n_block, T, H) if self.output_all_block else (T, H)

    def forward(self, x):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        dev = self.word.device
        ids = _ids(xs[0]).to(dev)
        T = ids.shape[1]
        types = _ids(xs[1]).to(dev) if len(xs) > 1 \
            else torch.zeros_like(ids)
        h = (_take(self.word, ids) + self.pos[:T]
             + _take(self.type_emb, types))
        h = self.emb_ln(h)
        attn_mask = None
        if len(xs) > 2:
            m = torch.as_tensor(xs[2]).to(dev)
            attn_mask = m.reshape(m.shape[0], -1)[:, None, None, :]
        outs = []
        for blk in self.blocks:
            h = blk(h, mask=attn_mask)
            outs.append(h)
        if self.output_all_block:
            return torch.stack(outs, dim=1)
        return h

    def pooled(self, seq_out):
        """tanh(W · first token) — the BERT pooler."""
        return torch.tanh(_linear(self.pooler, seq_out[:, 0]))
