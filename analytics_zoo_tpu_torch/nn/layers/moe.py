"""Mixture of experts — the JAX package's ``nn/layers/moe.py``: a top-k
gated MoE feed-forward layer, (B, T, D) -> (B, T, D), in the dense
formulation: every expert computes every token and the top-k softmax
gate zeroes the rest (no capacity factor, no dropped tokens, exact
gradients).

Params, the JAX layout: ``gate/W`` (D, E) and ``experts/{W1 (E, D, H),
b1 (E, H), W2 (E, H, D), b2 (E, D)}``, drawn N(0, 0.02²) (biases zero).

The gate keeps the k largest probabilities of each token and breaks ties
by index, lowest first, as ``lax.top_k`` does: a stable descending sort
(``torch.topk`` leaves the order of tied values unspecified, and a
threshold test would let an all-zero token, whose probabilities all tie,
pick every expert).

Expert parallelism comes through a sharding plan, as in JAX: a plan
that places the expert leaves' E axis over an axis (``P("expert")``)
puts the layer into its parallel form (``shard_leaves``), where each
rank holds and computes its own experts for every token and the
gate-weighted combine is a ``psum`` over the axis.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.module import Layer, to_shape


class MixtureOfExperts(Layer):
    """Top-k gated MoE FFN over ``num_experts`` experts of width
    ``hidden_dim``; ``aux_load_balance_loss(gates)`` is the Switch-style
    load-balance penalty."""

    def __init__(self, num_experts: int, hidden_dim: int, top_k: int = 2,
                 activation="gelu", aux_loss_weight: float = 0.01,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.E = int(num_experts)
        self.H = int(hidden_dim)
        self.k = int(top_k)
        if not 1 <= self.k <= self.E:
            raise ValueError(f"top_k={top_k} out of range for {num_experts} "
                             "experts")
        self.act = activations.get(activation)
        self.aux_loss_weight = float(aux_loss_weight)
        # expert-parallel form: (axis, mesh, leaves held as slices)
        self._tp = None
        self._build_declared()

    def build(self, input_shape):
        d = to_shape(input_shape)[-1]
        self.gate_W = nn.Parameter(torch.empty(d, self.E))
        self.W1 = nn.Parameter(torch.empty(self.E, d, self.H))
        self.b1 = nn.Parameter(torch.zeros(self.E, self.H))
        self.W2 = nn.Parameter(torch.empty(self.E, self.H, d))
        self.b2 = nn.Parameter(torch.zeros(self.E, d))

    def reset_parameters(self, gen):
        for w in (self.gate_W, self.W1, self.W2):
            w.copy_(0.02 * torch.randn(w.shape, generator=gen))
        self.b1.zero_()
        self.b2.zero_()

    def _tree(self) -> Dict:
        return {"gate": {"W": self.gate_W},
                "experts": {"W1": self.W1, "b1": self.b1, "W2": self.W2,
                            "b2": self.b2}}

    def shard_leaves(self, specs, mesh):
        """Expert-parallel form: the expert weights' E axis split over
        an axis (W1 and W2 both, the biases too or replicated), the gate
        replicated."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            Layout, check_specs, row_axis, take_shard)
        ax = row_axis(specs.get("experts/W1", ()))
        check_specs(self, specs, {"experts/W1": {(ax,)},
                                  "experts/W2": {(ax,)},
                                  "experts/b1": {(), (ax,)},
                                  "experts/b2": {(), (ax,)},
                                  "gate/W": {()}})
        lays, held = {}, set()
        for rel, attr in (("experts/W1", "W1"), ("experts/b1", "b1"),
                          ("experts/W2", "W2"), ("experts/b2", "b2")):
            if tuple(specs[rel]):
                lays[rel] = Layout(0, ax, 1)
                take_shard(self, attr, lays[rel], mesh)
                held.add(attr)
        self._tp = (ax, mesh, held)
        return lays

    def gates(self, x):
        """(B, T, E) top-k softmax gate weights, zero outside the top k,
        renormalized over it."""
        xw, gw = dtypes.cast_compute(x, self.gate_W)
        logits = torch.einsum("btd,de->bte", xw.to(torch.float32),
                              gw.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        if self.k >= self.E:
            return probs
        order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        mask = torch.zeros_like(probs).scatter_(-1, order[..., :self.k], 1.0)
        topk = probs * mask
        return topk / torch.clamp_min(topk.sum(-1, keepdim=True), 1e-9)

    def aux_load_balance_loss(self, gates):
        """E · Σ_e f_e · p_e: p the mean gate weight of an expert, f the
        share of tokens routed to it."""
        p = gates.mean(dim=(0, 1))
        f = (gates > 0).to(torch.float32).mean(dim=(0, 1))
        return self.E * torch.sum(p * f)

    def forward(self, x):
        g = self.gates(x)
        b1, b2 = self.b1, self.b2
        if self._tp is not None:
            # this rank's experts: x and their gate columns enter the
            # varying computation, the combine sums over the axis
            from analytics_zoo_tpu_torch.parallel import comm
            from analytics_zoo_tpu_torch.parallel.sharding import (
                Layout, held_or_sliced)
            ax, mesh, held = self._tp
            lay = Layout(0, ax, 1)
            e_l = self.W1.shape[0]
            x_in = comm.copy_to(x, ax, mesh)
            g = comm.copy_to(g, ax, mesh).narrow(-1, mesh.index(ax) * e_l,
                                                 e_l)
            b1 = held_or_sliced(b1, "b1" in held, lay, mesh)
            b2 = held_or_sliced(b2, "b2" in held, lay, mesh)
        else:
            x_in = x
        xw, W1, W2 = dtypes.cast_compute(x_in, self.W1, self.W2)
        f32 = torch.float32
        h = self.act(torch.einsum("btd,edh->bteh", xw.to(f32), W1.to(f32))
                     + b1)
        y = torch.einsum("bteh,ehd->bted", h.to(xw.dtype).to(f32),
                         W2.to(f32)) + b2
        out = torch.einsum("bted,bte->btd", y, g)
        if self._tp is not None:
            out = comm.psum(out, self._tp[0], self._tp[1])
        return out.to(x.dtype)
