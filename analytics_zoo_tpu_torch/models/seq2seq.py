"""``Seq2seq`` — an LSTM encoder/decoder with a bridge, the JAX package's
``models/seq2seq.py`` (Seq2seq.scala, RNNEncoder / RNNDecoder,
Bridge.scala).

The encoder's stacked LSTM reads the prompt's ids; its final states,
adapted by the bridge, start the decoder's stack; the decoder's top state
is projected onto the vocabulary.  The stacks use ``sigmoid`` and ``tanh``
(not the ``LSTM`` layer's hard_sigmoid default), gates in the order i, f,
g, o.

Paths, as in the JAX package:

- ``forward([enc_in, dec_in]) -> (B, T_dec, V)`` softmax, teacher forced
  (what ``Estimator.fit`` trains);
- ``init_decode(enc_in, lengths=None)`` — encoder + bridge, the decoder's
  initial state: a list of per-layer ``(h, c)`` pairs, each (B, H).
  ``lengths`` masks a right-padded prompt batch: a row's state stops
  changing at its length, so padding never reaches it and rows stay
  independent;
- ``decode_step(state, tokens) -> (logits (B, V), state)`` — one token
  for every row, allocating nothing that depends on the data and
  reading nothing back to the host, so the continuous batcher can
  capture a quantum of steps as one CUDA graph;
- ``infer`` — the greedy rollout over the same primitives, with the rows
  after ``stop_sign`` frozen and their lengths.

It is a bare-state model: no KV cache, so ``init_decode`` takes no
``cache_len`` and yields no first-token logits; the batcher starts every
row from ``GenerationParams.start_id``.  Ids are looked up as the JAX
``jnp.take(embed, ids.astype(int32))``: ``nn/layers/core.lookup``.

Its param tree is the JAX package's: ``{embed (V, E), encoder: [{Wx (d,
4H), Wh (H, 4H), b}, ...], decoder: [...], out: {W (H_last, V), b}}``
and, for the ``dense`` / ``densenonlinear`` bridges, ``bridge: {W (S,
S)}`` with S the sum of 2·H over the layers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.context import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.nn.layers.core import lookup
from analytics_zoo_tpu_torch.nn.layers.recurrent import matmul_f32
from analytics_zoo_tpu_torch.nn.models import KerasNet
from analytics_zoo_tpu_torch.nn.module import initializer

State = List[Tuple[torch.Tensor, torch.Tensor]]


class _LSTMCell(nn.Module):
    """One layer of a stack: ``Wx`` (d, 4H), ``Wh`` (H, 4H), ``b``."""

    def __init__(self, d: int, h: int):
        super().__init__()
        self.d, self.h = d, h
        self.Wx = nn.Parameter(torch.empty(d, 4 * h))
        self.Wh = nn.Parameter(torch.empty(h, 4 * h))
        self.b = nn.Parameter(torch.zeros(4 * h))

    def tree(self) -> Dict:
        return {"Wx": self.Wx, "Wh": self.Wh, "b": self.b}

    def step(self, x, h, c):
        H = self.h
        z = matmul_f32(x, self.Wx) + matmul_f32(h, self.Wh) + self.b
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        c_new = f * c + i * g
        return o * torch.tanh(c_new), c_new


def _stack_step(cells, states: State, x) -> Tuple[State, torch.Tensor]:
    """One step through a whole stack; returns the new states and the top
    layer's output."""
    new = []
    for cell, (h, c) in zip(cells, states):
        h, c = cell.step(x, h, c)
        new.append((h, c))
        x = h
    return new, x


class Seq2seq(KerasNet):
    """Call on ``[enc_inputs (B, T_enc) ids, dec_inputs (B, T_dec) ids]``
    (a trailing unit feature axis is dropped).

    ``bridge`` — the encoder-to-decoder state adapter (Bridge.scala):
    ``None`` / ``"passthrough"`` passes the states unchanged; ``"dense"``
    flattens every layer's (h, c) into one vector ``[h0, c0, h1, c1,
    ...]``, maps it by one bias-free dense ``W`` and splits it back;
    ``"densenonlinear"`` adds a tanh; a callable maps the flat (B, S)
    tensor itself.

    Weights are drawn by ``init_weights(seed)`` (or at construction from a
    generator seeded by the layer's name); the model lives on ``device``,
    ``cuda:0`` unless the caller passes ``device="cpu"``."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden_sizes: Sequence[int] = (128,), bridge="dense",
                 init="glorot_uniform", device: DeviceLike = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if not (bridge in (None, "passthrough", "dense", "densenonlinear")
                or callable(bridge)):
            raise ValueError(
                f"bridge must be None/'passthrough'/'dense'/"
                f"'densenonlinear' or a callable, got {bridge!r}")
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.bridge_kind = bridge
        self.init_name = init
        self._declared_input_shape = [(None,), (None,)]
        H = self.hidden_sizes
        self.embed = nn.Parameter(torch.empty(self.vocab_size,
                                              self.embed_dim))
        dims = (self.embed_dim,) + H[:-1]
        self.encoder = nn.ModuleList(
            [_LSTMCell(d, h) for d, h in zip(dims, H)])
        self.decoder = nn.ModuleList(
            [_LSTMCell(d, h) for d, h in zip(dims, H)])
        self.out_W = nn.Parameter(torch.empty(H[-1], self.vocab_size))
        self.out_b = nn.Parameter(torch.zeros(self.vocab_size))
        self.has_bridge_W = bridge in ("dense", "densenonlinear")
        if self.has_bridge_W:
            S = sum(2 * h for h in H)
            self.bridge_W = nn.Parameter(torch.empty(S, S))
        self.built = True
        self.init_weights(0)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset_parameters(self, gen):
        dev = self.embed.device
        draw = (lambda *a, **k: initializer(*a, **k).to(dev))
        self.embed.copy_(draw("uniform", gen, self.embed.shape))
        for stack in (self.encoder, self.decoder):
            for cell in stack:
                cell.Wx.copy_(draw(self.init_name, gen, cell.Wx.shape,
                                   fan_in=cell.d, fan_out=cell.h))
                cell.Wh.copy_(draw("orthogonal", gen, cell.Wh.shape))
                cell.b.zero_()
        self.out_W.copy_(draw(self.init_name, gen, self.out_W.shape))
        self.out_b.zero_()
        if self.has_bridge_W:
            self.bridge_W.copy_(draw(self.init_name, gen,
                                     self.bridge_W.shape))

    def compute_output_shape(self, input_shape):
        return (None, self.vocab_size)

    def _tree(self) -> Dict:
        tree = {"embed": self.embed,
                "encoder": [c.tree() for c in self.encoder],
                "decoder": [c.tree() for c in self.decoder],
                "out": {"W": self.out_W, "b": self.out_b}}
        if self.has_bridge_W:
            tree["bridge"] = {"W": self.bridge_W}
        return tree

    # -- pieces ---------------------------------------------------------------
    def _ids(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if t.ndim == 3 and t.shape[-1] == 1:
            t = t[..., 0]
        return t.to(self.device)

    def _embed(self, ids) -> torch.Tensor:
        """The JAX ``take(embed, ids.astype(int32))``: a float id is
        truncated first, and an int32 id then looked up."""
        return lookup(self.embed, ids)

    def _zero_states(self, batch: int) -> State:
        return [(torch.zeros((batch, h), device=self.device),
                 torch.zeros((batch, h), device=self.device))
                for h in self.hidden_sizes]

    def _encode(self, enc_in, lengths=None) -> State:
        xs = self._embed(enc_in)
        states = self._zero_states(xs.shape[0])
        for t in range(xs.shape[1]):
            new, _ = _stack_step(self.encoder, states, xs[:, t])
            if lengths is not None:
                keep = (t < lengths)[:, None]      # row still in its prompt
                new = [(torch.where(keep, hn, h), torch.where(keep, cn, c))
                       for (hn, cn), (h, c) in zip(new, states)]
            states = new
        return states

    def _bridge(self, states: State) -> State:
        kind = self.bridge_kind
        if kind in (None, "passthrough"):
            return states
        flat = torch.cat([t for hc in states for t in hc], dim=-1)
        if callable(kind):
            out = kind(flat)
        else:
            out = flat @ self.bridge_W
            if kind == "densenonlinear":
                out = torch.tanh(out)
        news, off = [], 0
        for h in self.hidden_sizes:
            news.append((out[:, off:off + h], out[:, off + h:off + 2 * h]))
            off += 2 * h
        return news

    def _project(self, h) -> torch.Tensor:
        return matmul_f32(h, self.out_W) + self.out_b

    # -- teacher-forced forward -----------------------------------------------
    def forward(self, inputs):
        enc_in, dec_in = self._ids(inputs[0]), self._ids(inputs[1])
        states = self._bridge(self._encode(enc_in))
        ys = self._embed(dec_in)
        tops = []
        for t in range(ys.shape[1]):
            states, top = _stack_step(self.decoder, states, ys[:, t])
            tops.append(top)
        logits = self._project(torch.stack(tops, dim=1))
        return torch.softmax(logits, dim=-1)

    # -- step-wise decode -----------------------------------------------------
    @torch.inference_mode()
    def init_decode(self, enc_in, lengths=None) -> State:
        """Encoder + bridge over a (possibly right-padded) prompt batch:
        the decoder's initial state, per layer ``(h, c)``.  ``lengths``
        (B,) holds each row's true prompt length; steps at or past it keep
        the row's state.  ``lengths=None`` = every row full-length."""
        enc_in = self._ids(enc_in)
        if lengths is not None:
            lengths = self._ids(lengths).to(torch.int32)
        return self._bridge(self._encode(enc_in, lengths))

    @torch.inference_mode()
    def decode_step(self, state: State, tokens):
        """One greedy-decode step for every row: embed ``tokens`` (B,),
        step the decoder stack, project onto the vocabulary.  Returns
        ``(logits (B, V), new_state)``."""
        tokens = self._ids(tokens).to(torch.int32)
        new, top = _stack_step(self.decoder, state, self._embed(tokens))
        return self._project(top), new

    @torch.inference_mode()
    def infer(self, enc_in, start_sign: int, max_seq_len: int = 30,
              stop_sign: Optional[int] = None, return_lengths: bool = False):
        """Greedy decode from ``start_sign`` for ``max_seq_len`` steps.
        With ``stop_sign``, a row's tokens after its stop sign are the
        stop sign and its state stays frozen; ``return_lengths=True``
        returns ``(tokens, lengths)``, a row's length counting its tokens
        before the stop sign (``max_seq_len`` when it never stops).  With
        ``stop_sign`` and no lengths asked for, each row is returned cut
        at its length."""
        enc_in = self._ids(enc_in)
        B = enc_in.shape[0]
        st = self.init_decode(enc_in)
        tok = torch.full((B,), int(start_sign), dtype=torch.int32,
                         device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        stop = -1 if stop_sign is None else int(stop_sign)
        toks, dones = [], []
        for _ in range(int(max_seq_len)):
            logits, new = self.decode_step(st, tok)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            if stop_sign is not None:
                nxt = torch.where(done, stop, nxt).to(torch.int32)
            new_done = done | (nxt == stop)
            keep = (~done)[:, None]
            st = [(torch.where(keep, hn, h), torch.where(keep, cn, c))
                  for (hn, cn), (h, c) in zip(new, st)]
            tok, done = nxt, new_done
            toks.append(nxt)
            dones.append(new_done)
        out = torch.stack(toks, dim=1).cpu().numpy() if toks \
            else np.zeros((B, 0), np.int32)
        done_steps = torch.stack(dones).sum(0).cpu().numpy() if dones \
            else np.zeros((B,), np.int64)
        lengths = (int(max_seq_len) - done_steps).astype(np.int64)
        if stop_sign is not None and not return_lengths:
            return [row[:n] for row, n in zip(out, lengths)]
        if return_lengths:
            return out, lengths
        return out
