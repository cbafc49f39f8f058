"""The JAX package's ``models/textmodels.py``: ``TransformerLM``, the
decoder-only generator the serving plane's continuous batcher drives, and
the tagger family (``NER``, ``SequenceTagger``, ``IntentEntity``; the
section at the end of this module).

GPT-2's architecture: pre-LN blocks (LayerNorm eps 1e-5, population
variance), learned positions, biased ``qkv``/``proj``/``fc1``/``fc2``,
tanh-approximate GELU and a weight-tied output head.  The module owns its
parameters and keeps the JAX layout — every dense ``W`` is (d_in, d_out)
and applies as ``x @ W + b`` — so ``utils/convert.load_jax_params`` is a
copy, not a transpose puzzle.

Paths, as in the JAX package:

- ``forward(ids) -> (B, T, V)`` logits (teacher forcing);
- ``init_decode`` / ``decode_step`` — prefill into fixed-length per-row
  caches, then one token a call;
- paged paths: ``init_paged_pools`` allocates the block pool,
  ``prefill_kv`` is the prompt forward without caches (raw K/V for the
  batcher to commit into pool blocks), ``prefill_shared`` the suffix-only
  prefill over a shared prefix read from the pool, and ``decode_paged``
  one token a row against the pool through ``ops/paged_attention`` (the
  hand-written CUDA kernel on the card);
- ``generate`` — a greedy rollout of the whole batch (the static-batching
  baseline).

Caches and pools are updated IN PLACE, where the JAX package's
``.at[].set`` copies: a decode step writes its token's K/V into the buffers
it was given and returns them.  The prefill attention stays as the JAX
package writes it (einsum, mask filled with ``-1e30``, softmax): a boolean
``-inf`` mask would give NaN rows for fully padded queries.

The decode-side methods run under ``torch.inference_mode``, so they may be
called from any thread (the mode is thread-local).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.context import (DeviceLike, ZooConf,
                                                    ZooContext, get_context,
                                                    resolve_device)
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.inference.quantize import kv_pack_int8
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout, Embedding
from analytics_zoo_tpu_torch.nn.layers.crf import CRF
from analytics_zoo_tpu_torch.nn.layers.recurrent import LSTM, Bidirectional
from analytics_zoo_tpu_torch.nn.module import Layer
from analytics_zoo_tpu_torch.nn.optimizers import Adam
from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention

NEG_INF = -1e30


class _Dense(nn.Module):
    """``x @ W + b`` with ``W`` in the JAX layout (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, std: float,
                 gen: torch.Generator):
        super().__init__()
        self.W = nn.Parameter(torch.randn(d_in, d_out, generator=gen) * std)
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return torch.matmul(x, self.W) + self.b


class _LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.g + self.b


class _Block(nn.Module):
    def __init__(self, hidden: int, std: float, gen: torch.Generator):
        super().__init__()
        self.ln1 = _LayerNorm(hidden)
        self.qkv = _Dense(hidden, 3 * hidden, std, gen)
        self.proj = _Dense(hidden, hidden, std, gen)
        self.ln2 = _LayerNorm(hidden)
        self.fc1 = _Dense(hidden, 4 * hidden, std, gen)
        self.fc2 = _Dense(4 * hidden, hidden, std, gen)

    def mlp(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                   approximate="tanh"))


class TransformerLM(Layer):
    """Decoder-only transformer language model with KV-cache step APIs.

    Weights are drawn from ``seed`` through an explicit
    ``torch.Generator`` (normal, std ``initializer_range``; zero biases,
    unit LayerNorm gains) on the host, then moved to ``device`` —
    ``cuda:0`` unless the caller passes ``device="cpu"``."""

    def __init__(self, vocab_size: int, hidden: int = 64, n_head: int = 4,
                 n_layers: int = 2, max_len: int = 512,
                 initializer_range: float = 0.02, *, seed: int = 0,
                 device: DeviceLike = None, name: Optional[str] = None):
        super().__init__(name=name)
        if hidden % n_head:
            raise ValueError(f"hidden={hidden} not divisible by "
                             f"n_head={n_head}")
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.n_head = int(n_head)
        self.n_layers = int(n_layers)
        self.max_len = int(max_len)
        self.std = float(initializer_range)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        H, std = self.hidden, self.std
        self.embed = nn.Parameter(
            torch.randn(self.vocab_size, H, generator=gen) * std)
        self.pos = nn.Parameter(
            torch.randn(self.max_len, H, generator=gen) * std)
        self.ln_f = _LayerNorm(H)
        self.blocks = nn.ModuleList(
            [_Block(H, std, gen) for _ in range(self.n_layers)])
        self.to(dev)

    # -- shared pieces --------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_head

    def _ids(self, x) -> torch.Tensor:
        """Token ids as a long tensor on the model's device; a trailing
        unit feature axis is dropped."""
        t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        if t.ndim == 3 and t.shape[-1] == 1:
            t = t[..., 0]
        return t.to(self.device, torch.long)

    def _ints(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        return t.to(self.device, torch.int32)

    def _heads(self, x):
        # (..., H) -> (..., n_head, head_dim)
        return x.reshape(x.shape[:-1] + (self.n_head, self.head_dim))

    def _qkv(self, blk, x):
        q, k, v = blk.qkv(blk.ln1(x)).split(self.hidden, dim=-1)
        return self._heads(q), self._heads(k), self._heads(v)

    def _logits(self, h):
        # weight-tied head: logits = h @ embed.T
        return torch.matmul(self.ln_f(h), self.embed.t())

    @staticmethod
    def _attend(q, k, v, mask):
        """Masked attention as the JAX package writes it: q (B, Q, nh, hd),
        k/v (B, K, nh, hd), mask broadcastable to (B, nh, Q, K)."""
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) \
            * (1.0 / math.sqrt(q.shape[-1]))
        att = torch.where(mask, att, NEG_INF)
        att = torch.softmax(att, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", att, v)

    # -- monolithic forward (teacher forcing) ---------------------------------
    def forward(self, ids):
        ids = self._ids(ids)
        B, T = ids.shape
        x = self.embed[ids] + self.pos[:T]
        causal = torch.ones(T, T, dtype=torch.bool,
                            device=self.device).tril()
        for blk in self.blocks:
            q, k, v = self._qkv(blk, x)
            o = self._attend(q, k, v, causal[None, None])
            x = blk.mlp(x + blk.proj(o.reshape(B, T, self.hidden)))
        return self._logits(x)

    # -- step-wise decode -----------------------------------------------------
    def _prefill_core(self, prompt, lengths):
        """Shared prompt forward of ``init_decode`` and ``prefill_kv``.
        Returns ``(ks, vs, logits0, lengths)`` with ``ks``/``vs`` per-layer
        (B, P, nh, hd)."""
        prompt = self._ids(prompt)
        B, P = prompt.shape
        lengths = (torch.full((B,), P, dtype=torch.int32,
                              device=self.device) if lengths is None
                   else self._ints(lengths))
        x = self.embed[prompt] + self.pos[:P]
        pos_idx = torch.arange(P, device=self.device)
        # causal within the prompt AND key < row length (padding masked)
        mask = (pos_idx[None, :, None] >= pos_idx[None, None, :]) \
            & (pos_idx[None, None, :] < lengths[:, None, None])  # (B,P,P)
        ks, vs = [], []
        for blk in self.blocks:
            q, k, v = self._qkv(blk, x)
            o = self._attend(q, k, v, mask[:, None])
            x = blk.mlp(x + blk.proj(o.reshape(B, P, self.hidden)))
            ks.append(k)
            vs.append(v)
        # each row's next-token logits live at its LAST REAL position
        last = x[torch.arange(B, device=self.device),
                 torch.clamp_min(lengths.long() - 1, 0)]
        return ks, vs, self._logits(last), lengths

    @torch.inference_mode()
    def init_decode(self, prompt, lengths=None,
                    cache_len: Optional[int] = None):
        """Prefill into ``cache_len``-capacity per-row caches.  Returns
        ``(state, logits0)``; ``state`` = {"pos", "k", "v"}."""
        prompt = self._ids(prompt)
        B, P = prompt.shape
        C = int(cache_len) if cache_len is not None else int(P)
        if C < P:
            raise ValueError(f"cache_len={C} < prompt bucket {P}")
        if C > self.max_len:
            raise ValueError(f"cache_len={C} > max_len={self.max_len}")
        ks, vs, logits0, lengths = self._prefill_core(prompt, lengths)
        state = {"pos": lengths, "k": [], "v": []}
        for k, v in zip(ks, vs):
            for name, t in (("k", k), ("v", v)):
                c = torch.zeros((B, C, self.n_head, self.head_dim),
                                device=self.device)
                c[:, :P] = t
                state[name].append(c)
        return state, logits0

    @torch.inference_mode()
    def prefill_kv(self, prompt, lengths=None):
        """Paged prefill: the prompt forward without caches — returns
        ``(ks, vs, logits0)`` with per-layer raw (B, P, nh, hd) K/V for the
        batcher to commit into pool blocks."""
        ks, vs, logits0, _ = self._prefill_core(prompt, lengths)
        return ks, vs, logits0

    @torch.inference_mode()
    def decode_step(self, state, tokens):
        """One token for every row: write K/V at the row cursor (in place),
        attend over the written prefix, advance.  Returns ``(logits (B, V),
        state)``."""
        tokens = self._ids(tokens)
        pos = state["pos"]
        B = tokens.shape[0]
        C = state["k"][0].shape[1]
        rows = torch.arange(B, device=self.device)
        # clamp the cursor so a full cache row keeps overwriting its last
        # slot instead of indexing out of bounds
        wpos = torch.clamp_max(pos.long(), C - 1)
        x = self.embed[tokens] \
            + self.pos[torch.clamp_max(pos.long(), self.max_len - 1)]
        valid = torch.arange(C, device=self.device)[None] \
            <= wpos[:, None]                                     # (B, C)
        for li, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x)
            kc, vc = state["k"][li], state["v"][li]
            kc[rows, wpos] = k
            vc[rows, wpos] = v
            o = self._attend(q[:, None], kc, vc,
                             valid[:, None, None, :])[:, 0]
            x = blk.mlp(x + blk.proj(o.reshape(B, self.hidden)))
        return self._logits(x), {"pos": pos + 1, "k": state["k"],
                                 "v": state["v"]}

    # -- paged KV pool --------------------------------------------------------
    @torch.inference_mode()
    def init_paged_pools(self, n_blocks: int, block_len: int,
                         max_active: int, kv_quant: str = "off"):
        """Zeroed pool dict for the paged batcher.  ``n_blocks`` counts the
        TRASH block (row 0).  int8 mode adds per-(block, head) scale planes
        and per-slot f32 STAGING buffers holding each row's active (partial)
        block exactly, so every append re-quantizes from exact values."""
        if kv_quant not in ("off", "int8"):
            raise ValueError(f"kv_quant must be off|int8, got {kv_quant!r}")
        nh, hd, L = self.n_head, self.head_dim, self.n_layers
        kdt = torch.int8 if kv_quant == "int8" else torch.float32

        def planes(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(L)]

        pools = {"k": planes((n_blocks, block_len, nh, hd), kdt),
                 "v": planes((n_blocks, block_len, nh, hd), kdt)}
        if kv_quant == "int8":
            pools["ks"] = planes((n_blocks, nh), torch.float32)
            pools["vs"] = planes((n_blocks, nh), torch.float32)
            pools["stk"] = planes((max_active, block_len, nh, hd),
                                  torch.float32)
            pools["stv"] = planes((max_active, block_len, nh, hd),
                                  torch.float32)
        return pools

    @torch.inference_mode()
    def prefill_shared(self, suffix, lengths, prefix_len, prefix_k,
                       prefix_v):
        """Suffix-only prefill for prefix-cache hits: the shared prefix's
        K/V (per-layer (B, PL, nh, hd) f32, gathered from the pool by the
        caller) joins attention as extra keys; only the ``suffix`` tokens
        run through the stack.  Rows' prefix lengths ``prefix_len`` mask
        the gather padding; suffix positions embed at ``prefix_len + i``.
        Returns SUFFIX-only ``(ks, vs, logits0)``."""
        suffix = self._ids(suffix)
        B, S = suffix.shape
        lengths = self._ints(lengths)                # suffix lengths
        prefix_len = self._ints(prefix_len)
        PL = prefix_k[0].shape[1]
        dev = self.device
        qi = torch.arange(S, device=dev)
        gpos = torch.clamp_max(prefix_len.long()[:, None] + qi,
                               self.max_len - 1)         # (B, S) global pos
        x = self.embed[suffix] + self.pos[gpos]
        # keys = [prefix (PL) | suffix (S)]: prefix key j valid iff
        # j < prefix_len[row]; suffix key js valid iff causal AND real
        pmask = torch.arange(PL, device=dev)[None, None, :] \
            < prefix_len[:, None, None]                  # (B, 1, PL)
        smask = (qi[None, :, None] >= qi[None, None, :]) \
            & (qi[None, None, :] < lengths[:, None, None])   # (B, S, S)
        mask = torch.cat([pmask.expand(B, S, PL), smask], dim=2)
        ks, vs = [], []
        for li, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x)
            kk = torch.cat([prefix_k[li].to(torch.float32), k], dim=1)
            vv = torch.cat([prefix_v[li].to(torch.float32), v], dim=1)
            o = self._attend(q, kk, vv, mask[:, None])
            x = blk.mlp(x + blk.proj(o.reshape(B, S, self.hidden)))
            ks.append(k)
            vs.append(v)
        last = x[torch.arange(B, device=dev),
                 torch.clamp_min(lengths.long() - 1, 0)]
        return ks, vs, self._logits(last)

    @torch.inference_mode()
    def decode_paged(self, pstate, block_tables, pos, tokens, *,
                     block_len: int, kv_quant: str = "off", impl=None):
        """One token per row against the block pool: ``decode_step``'s math
        with the cache write routed through each row's block table and the
        read through ``ops/paged_attention``.  Inactive rows point their
        whole table at the trash block, so their writes land harmlessly.
        int8 mode re-packs the row's ACTIVE block from its exact f32 staging
        copy every step and scatters block + scale into the pool.  The pool
        tensors are updated in place; returns ``(logits, pstate)`` — the
        caller advances ``pos``."""
        tokens = self._ids(tokens)
        pos = self._ints(pos)
        bt = self._ints(block_tables).contiguous()
        A, T = bt.shape
        bl = int(block_len)
        rows = torch.arange(A, device=self.device)
        pos_l = pos.long()
        off = pos_l % bl
        # clamp like decode_step's cursor: an overshooting row keeps
        # rewriting its last table entry instead of indexing out of range
        cur = bt[rows, torch.clamp_max(pos_l // bl, T - 1)].long()
        x = self.embed[tokens] \
            + self.pos[torch.clamp_max(pos_l, self.max_len - 1)]
        lengths = (pos + 1).contiguous()
        quant = kv_quant == "int8"
        if quant:
            reset = (off == 0)[:, None, None, None]
        for li, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x)
            kp, vp = pstate["k"][li], pstate["v"][li]
            if quant:
                # staging reset on block rollover (off == 0), then append
                stk, stv = pstate["stk"][li], pstate["stv"][li]
                stk.masked_fill_(reset, 0.0)
                stv.masked_fill_(reset, 0.0)
                stk[rows, off] = k
                stv[rows, off] = v
                qk, sk = kv_pack_int8(stk)                 # (A,bl,nh,hd)
                qv, sv = kv_pack_int8(stv)
                kp[cur] = qk
                vp[cur] = qv
                pstate["ks"][li][cur] = sk
                pstate["vs"][li][cur] = sv
                o = paged_attention(q.contiguous(), kp, vp, bt, lengths,
                                    pstate["ks"][li], pstate["vs"][li],
                                    impl=impl)
            else:
                kp[cur, off] = k
                vp[cur, off] = v
                o = paged_attention(q.contiguous(), kp, vp, bt, lengths,
                                    impl=impl)
            x = blk.mlp(x + blk.proj(o.reshape(A, self.hidden)))
        return self._logits(x), pstate

    # -- monolithic greedy rollout (batch-in/batch-out baseline) --------------
    @torch.inference_mode()
    def generate(self, prompt, max_tokens: int = 32,
                 eos_id: Optional[int] = None, lengths=None,
                 return_lengths: bool = False):
        """Greedy decode of the whole batch: every row runs ``max_tokens``
        steps (the static-batching baseline).  Post-EOS tokens freeze to
        ``eos_id``; ``return_lengths`` yields per-row generated lengths."""
        prompt = np.asarray(prompt)
        B, P = prompt.shape[:2]
        # the KV cache cannot outgrow max_len: clamp the budget to the
        # remaining capacity
        room = self.max_len - P
        if room < 1:
            raise ValueError(f"prompt length {P} leaves no decode room "
                             f"(max_len={self.max_len})")
        max_tokens = min(int(max_tokens), room)
        state, logits0 = self.init_decode(prompt, lengths=lengths,
                                          cache_len=P + max_tokens)
        stop = -1 if eos_id is None else int(eos_id)
        tok = logits0.argmax(dim=-1)
        done = tok == stop
        outs = [tok]
        done_steps = done.long()
        for _ in range(max(max_tokens - 1, 0)):
            logits, state = self.decode_step(state, tok)
            nxt = logits.argmax(dim=-1)
            if eos_id is not None:
                nxt = torch.where(done, stop, nxt)
            done = done | (nxt == stop)
            done_steps = done_steps + done.long()
            outs.append(nxt)
            tok = nxt
        out = torch.stack(outs, dim=1).cpu().numpy().astype(np.int32)
        lengths_out = (max_tokens - done_steps.cpu().numpy()).astype(
            np.int64)
        if return_lengths:
            return out, lengths_out
        return out


# -- the taggers (TFPark's text Keras models) ---------------------------------
#
# ``NER`` (pyzoo/zoo/tfpark/text/keras/ner.py), ``SequenceTagger``
# (pos_tagging.py) and ``IntentEntity`` (intent_extraction.py), on one
# trunk: a word embedding beside a character BiLSTM's word features, then
# a sentence BiLSTM.  Inputs are ``[word_ids (B, T), char_ids (B, T, W)]``.
# Param trees as the JAX package's: ``{enc: {wemb, cemb, clstm, slstm},
# head<i>: {W, b}, crf: {transitions, start, end}}``.  No kernel runs here:
# the recurrences are ``nn/layers/recurrent.py``'s and the heads float
# ``Dense``s (the quantizer does not walk into a bare ``Layer``).


class _WordCharEncoder(Layer):
    """Word embedding + char-BiLSTM word features -> sentence BiLSTM states
    (B, T, 2·lstm_dim).  The char BiLSTM runs over the (B·T, W) words and
    keeps its last state; ``word_length``, when given, must be the char
    input's width."""

    def __init__(self, word_vocab_size, char_vocab_size, word_emb_dim=100,
                 char_emb_dim=30, lstm_dim=100, dropout=0.5,
                 word_length=None, name=None):
        super().__init__(name=name)
        self.word_emb = Embedding(word_vocab_size, word_emb_dim,
                                  name=self.name + "_wemb")
        self.char_emb = Embedding(char_vocab_size, char_emb_dim,
                                  name=self.name + "_cemb")
        self.char_lstm = Bidirectional(
            LSTM(char_emb_dim, inner_activation="sigmoid"),
            input_shape=(None, char_emb_dim), name=self.name + "_clstm")
        self.sent_lstm = Bidirectional(
            LSTM(lstm_dim, inner_activation="sigmoid",
                 return_sequences=True),
            input_shape=(None, word_emb_dim + 2 * char_emb_dim),
            name=self.name + "_slstm")
        self.drop = Dropout(dropout, name=self.name + "_drop")
        self.dims = (word_emb_dim, char_emb_dim, lstm_dim)
        self.word_length = word_length
        self.built = True

    def reset_parameters(self, gen):
        for layer in (self.word_emb, self.char_emb, self.char_lstm,
                      self.sent_lstm):
            layer.reset_parameters(gen)

    def _tree(self) -> Dict:
        return {"wemb": self.word_emb, "cemb": self.char_emb,
                "clstm": self.char_lstm, "slstm": self.sent_lstm}

    def forward(self, inputs):
        word_ids, char_ids = inputs
        B, T = word_ids.shape[:2]
        W = char_ids.shape[-1]
        if self.word_length is not None and W != self.word_length:
            raise ValueError(
                f"char input width {W} != configured word_length "
                f"{self.word_length}")
        w = self.word_emb(word_ids)
        c = self.char_emb(char_ids.reshape(B * T, W))
        cw = self.char_lstm(c).reshape(B, T, -1)
        h = self.drop(torch.cat([w, cw], dim=-1))
        return self.sent_lstm(h)


class _TaggerModel(Layer):
    """The encoder, one ``Dense`` a head (head ``pooled_head`` fed the mean
    of the states over every position, padding included) and, with
    ``use_crf``, a CRF over head 0.  The CRF's potentials ride in the
    output, broadcast over the batch, because the Estimator's loss sees
    only ``(y_pred, y_true)``: the loss then differentiates them."""

    def __init__(self, head_dims: Tuple[int, ...], use_crf: bool = True,
                 pooled_head: Optional[int] = None, **enc_kw):
        super().__init__()
        self.encoder = _WordCharEncoder(name=self.name + "_enc", **enc_kw)
        self.head_dims = tuple(head_dims)
        lstm_out = 2 * self.encoder.dims[2]
        self.heads = nn.ModuleList(
            Dense(d, input_shape=(lstm_out,), name=f"{self.name}_head{i}")
            for i, d in enumerate(self.head_dims))
        self.use_crf = use_crf
        self.pooled_head = pooled_head
        self.crf = CRF(self.head_dims[0], name=self.name + "_crf") \
            if use_crf else None
        self.built = True

    def reset_parameters(self, gen):
        for layer in self.sublayers():
            layer.reset_parameters(gen)

    def _tree(self) -> Dict:
        tree = {"enc": self.encoder}
        tree.update({f"head{i}": h for i, h in enumerate(self.heads)})
        if self.crf is not None:
            tree["crf"] = self.crf
        return tree

    def forward(self, inputs):
        h = self.encoder(inputs)
        outs = [head(h.mean(dim=1) if i == self.pooled_head else h)
                for i, head in enumerate(self.heads)]
        if self.crf is not None:
            B = outs[0].shape[0]
            outs += [p.expand((B,) + tuple(p.shape)) for p in
                     (self.crf.transitions, self.crf.start, self.crf.end)]
        return outs[0] if len(outs) == 1 else tuple(outs)


class _TextModelBase:
    """fit / predict plumbing shared by the taggers.  An entry point: the
    model goes to ``cuda:0`` unless ``device`` says otherwise.  With no
    ``ctx`` the Estimator takes the global context, or where none can be
    made (no CUDA), one on the model's device."""

    def __init__(self, model: _TaggerModel, loss, optimizer=None, ctx=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if ctx is None:
            try:
                ctx = get_context()
            except RuntimeError:
                ctx = ZooContext(ZooConf.from_env(device=str(self.device)))
        self.estimator = Estimator(self.model,
                                   optimizer=optimizer or Adam(lr=1e-3),
                                   loss=loss, ctx=ctx)

    def fit(self, x, y, *, batch_size=32, epochs=1, **kw):
        return self.estimator.fit(list(x), y, batch_size=batch_size,
                                  epochs=epochs, **kw)

    def predict(self, x, *, batch_size=32):
        return self.estimator.predict(list(x), batch_size=batch_size)


def _pick(logp, idx):
    """``-logp[..., idx]`` per position (the JAX ``take_along_axis``)."""
    return -logp.gather(-1, idx[..., None])[..., 0]


class NER(_TextModelBase):
    """BiLSTM + CRF named-entity tagger.  ``fit`` labels: (B, T) int tags;
    ``predict`` returns the Viterbi tag paths (B, T)."""

    def __init__(self, num_entities, word_vocab_size, char_vocab_size,
                 word_length=12, word_emb_dim=100, char_emb_dim=30,
                 tagger_lstm_dim=100, dropout=0.5, optimizer=None, ctx=None,
                 device: DeviceLike = None):
        model = _TaggerModel((num_entities,), use_crf=True,
                             word_vocab_size=word_vocab_size,
                             char_vocab_size=char_vocab_size,
                             word_emb_dim=word_emb_dim,
                             char_emb_dim=char_emb_dim,
                             lstm_dim=tagger_lstm_dim, dropout=dropout,
                             word_length=word_length)

        def crf_loss(y_pred, y_true):
            emissions, trans, start, end = y_pred
            tags = y_true.to(torch.int64)
            if tags.ndim == 3:
                tags = tags[..., 0]
            return model.crf.neg_log_likelihood(
                emissions, tags, params={"transitions": trans[0],
                                         "start": start[0], "end": end[0]})

        super().__init__(model, crf_loss, optimizer, ctx, device)

    def predict(self, x, *, batch_size=32):
        emissions = super().predict(x, batch_size=batch_size)[0]
        return self.model.crf.decode(
            torch.as_tensor(emissions, device=self.device)).cpu().numpy()


class SequenceTagger(_TextModelBase):
    """Joint POS + chunk tagger: two per-token softmax heads.  ``fit``
    labels: (B, T, 2) int [pos, chunk]."""

    def __init__(self, num_pos_labels, num_chunk_labels, word_vocab_size,
                 char_vocab_size, word_length=12, word_emb_dim=100,
                 char_emb_dim=30, tagger_lstm_dim=100, dropout=0.5,
                 optimizer=None, ctx=None, device: DeviceLike = None):
        model = _TaggerModel((num_pos_labels, num_chunk_labels),
                             use_crf=False,
                             word_vocab_size=word_vocab_size,
                             char_vocab_size=char_vocab_size,
                             word_emb_dim=word_emb_dim,
                             char_emb_dim=char_emb_dim,
                             lstm_dim=tagger_lstm_dim, dropout=dropout,
                             word_length=word_length)

        def joint_loss(y_pred, y_true):
            pos_logits, chunk_logits = y_pred
            t = y_true.to(torch.int64)
            nll_p = _pick(F.log_softmax(pos_logits, dim=-1), t[..., 0])
            nll_c = _pick(F.log_softmax(chunk_logits, dim=-1), t[..., 1])
            return (nll_p + nll_c).mean(dim=-1)

        super().__init__(model, joint_loss, optimizer, ctx, device)


class IntentEntity(_TextModelBase):
    """Joint intent classification + entity extraction: a pooled intent
    head and a per-token entity head.  ``fit`` labels: (B, 1 + T) int
    [intent, entity tags...]."""

    def __init__(self, num_intents, num_entities, word_vocab_size,
                 char_vocab_size, word_length=12, word_emb_dim=100,
                 char_emb_dim=30, tagger_lstm_dim=100, dropout=0.5,
                 optimizer=None, ctx=None, device: DeviceLike = None):
        model = _TaggerModel((num_entities, num_intents), use_crf=False,
                             pooled_head=1,
                             word_vocab_size=word_vocab_size,
                             char_vocab_size=char_vocab_size,
                             word_emb_dim=word_emb_dim,
                             char_emb_dim=char_emb_dim,
                             lstm_dim=tagger_lstm_dim, dropout=dropout,
                             word_length=word_length)

        def joint_loss(y_pred, y_true):
            ent_logits, intent_logits = y_pred
            t = y_true.to(torch.int64)
            nll_i = _pick(F.log_softmax(intent_logits, dim=-1), t[:, 0])
            nll_e = _pick(F.log_softmax(ent_logits, dim=-1),
                          t[:, 1:]).mean(dim=-1)
            return nll_i + nll_e

        super().__init__(model, joint_loss, optimizer, ctx, device)
