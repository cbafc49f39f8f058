"""Linear-chain conditional random field — the JAX package's
``nn/layers/crf.py`` (``CRF`` :24), the CRF head of the tagger models
(``models/textmodels.NER``).

The layer owns its potentials, keyed as the JAX tree: ``transitions``
(K, K) (``transitions[i, j]`` scores tag i followed by tag j), ``start``
(K,) and ``end`` (K,).  ``forward`` returns the emissions unchanged; the
CRF shapes training through ``neg_log_likelihood`` used as the loss, and
``decode`` gives the Viterbi paths.

The JAX package runs the forward recursion and Viterbi as ``lax.scan``
over the time axis; here each is a Python loop over T on (B, K) tensors,
in f32, and gradients come from autograd.  Every scoring method takes
the potentials from ``params`` when given (``NER``'s loss passes the ones
that ride in ``y_pred``), else the layer's own.  ``mask`` (B, T) marks the
valid steps: a padded step keeps the running scores, and in ``decode``
carries an identity backpointer, so padded steps repeat the last valid
tag.  ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does,
so ties decode alike.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.nn.module import Layer


class CRF(Layer):
    """Emissions (B, T, K) -> a CRF with learned (K, K) transitions."""

    def __init__(self, num_tags: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.num_tags = int(num_tags)
        # the potentials' shapes follow from num_tags alone
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        K = self.num_tags
        self.transitions = nn.Parameter(torch.empty(K, K))
        self.start = nn.Parameter(torch.zeros(K))
        self.end = nn.Parameter(torch.zeros(K))

    def reset_parameters(self, gen):
        self.transitions.copy_(0.01 * torch.randn(self.transitions.shape,
                                                  generator=gen))
        self.start.zero_()
        self.end.zero_()

    def _tree(self) -> Dict:
        return {"transitions": self.transitions, "start": self.start,
                "end": self.end}

    def forward(self, x):
        return x

    # -- scoring -------------------------------------------------------------
    def _potentials(self, params: Optional[Dict]):
        p = params if params is not None else self._tree()
        return (p["transitions"].to(torch.float32),
                p["start"].to(torch.float32), p["end"].to(torch.float32))

    @staticmethod
    def _mask(emissions, mask):
        if mask is None:
            return emissions.new_ones(emissions.shape[:2],
                                      dtype=torch.float32)
        return torch.as_tensor(mask, device=emissions.device).to(
            torch.float32)

    def log_partition(self, emissions, mask=None,
                      params: Optional[Dict] = None):
        """log Z (B,) by the forward algorithm."""
        m = self._mask(emissions, mask)
        e = emissions.to(torch.float32)
        trans, start, end = self._potentials(params)
        alpha = start + e[:, 0]
        for t in range(1, e.shape[1]):
            scores = alpha[:, :, None] + trans[None] + e[:, t, None, :]
            new = torch.logsumexp(scores, dim=1)
            alpha = torch.where(m[:, t, None] > 0, new, alpha)
        return torch.logsumexp(alpha + end[None], dim=-1)

    def score(self, emissions, tags, mask=None,
              params: Optional[Dict] = None):
        """Path score (B,) of the tag sequences ``tags`` (B, T); the end
        bonus applies at each row's last valid step."""
        m = self._mask(emissions, mask)
        e = emissions.to(torch.float32)
        t = torch.as_tensor(tags, device=e.device).to(torch.int64)
        trans, start, end = self._potentials(params)
        emit = e.gather(-1, t[..., None])[..., 0]
        pair = trans[t[:, :-1], t[:, 1:]] * m[:, 1:]
        last_idx = (m.sum(-1).to(torch.int64) - 1).clamp_min(0)
        last_tag = t.gather(1, last_idx[:, None])[:, 0]
        return ((emit * m).sum(-1) + pair.sum(-1) + start[t[:, 0]]
                + end[last_tag])

    def neg_log_likelihood(self, emissions, tags, mask=None,
                           params: Optional[Dict] = None):
        """(B,) -log p(tags | emissions): the loss."""
        return self.log_partition(emissions, mask, params) \
            - self.score(emissions, tags, mask, params)

    # -- decoding ------------------------------------------------------------
    @torch.no_grad()
    def decode(self, emissions, mask=None, params: Optional[Dict] = None):
        """Viterbi best paths (B, T) int32."""
        m = self._mask(emissions, mask)
        e = emissions.to(torch.float32)
        trans, start, end = self._potentials(params)
        K = e.shape[-1]
        ident = torch.arange(K, device=e.device)[None, :]
        delta = start + e[:, 0]
        bps = []
        for t in range(1, e.shape[1]):
            scores = delta[:, :, None] + trans[None] + e[:, t, None, :]
            new = scores.amax(dim=1)
            best_prev = scores.argmax(dim=1)
            valid = m[:, t, None] > 0
            delta = torch.where(valid, new, delta)
            bps.append(torch.where(valid, best_prev, ident))
        tag = (delta + end[None]).argmax(dim=-1)
        path = [tag]
        for bp in reversed(bps):
            tag = bp.gather(1, tag[:, None])[:, 0]
            path.append(tag)
        path.reverse()
        return torch.stack(path, dim=1).to(torch.int32)
