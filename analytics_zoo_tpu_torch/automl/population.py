"""Population training — the JAX package's ``automl/population.py``: K
hyperparameter variants of ONE architecture trained at once (reference
scale-out analog: RayTuneSearchEngine.py:133-150 running trials on
cluster workers).

The JAX trainer vmaps ``model.apply`` over a leading population axis of
the parameters inside one jitted program.  Here the members' parameters
are stacked along a leading axis of size K and a step is
``torch.func.vmap`` of ``grad_and_value`` over
``torch.func.functional_call(model, member_params, batch)``: one batched
forward and backward for all K members, so the card sees K-wide batched
products instead of K sequential tiny ones.

- Every member sees the same batches: one permutation an epoch from an
  explicit ``torch.Generator`` seeded ``seed + 1`` (the JAX trainer
  permutes with ``PRNGKey(seed + 1)``'s splits; the draws differ), the
  last partial batch dropped.
- A generator cannot be used inside ``vmap``, so each dropout site's
  uniform draws, shaped (K, ...), are drawn from the same generator
  before the step and handed to the members through
  ``nn/module.dropout_draws``; a site is found by one forward in
  training mode before the first epoch.
- The update is the trainer's own Adam (the JAX ``population.py:62-67``:
  b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias corrections
  from a float32 step count), with one learning rate a member.
- Member k starts from ``model.init_weights(split_seed(seed, k))``; the
  model's own weights are restored when ``fit`` returns.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn import objectives
from analytics_zoo_tpu_torch.nn.module import dropout_draws, split_seed
from analytics_zoo_tpu_torch.utils.convert import export_params


def _as_tensor(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy().copy()


class PopulationTrainer:
    """Train K same-architecture members at once with per-member Adam(lr).

    model: a built port model (``Sequential`` / ``Model``) on its device;
    its forward is vmapped over a leading population axis.  Members differ
    in init seed, lr and dropout draws.
    """

    def __init__(self, model, loss_fn: Optional[Callable] = None):
        self.model = model
        self.loss_fn = objectives.get(loss_fn or "mse")

    # -- members' weights -------------------------------------------------------
    def _member_init(self, k: int, seed: int) -> None:
        """Draw member ``k``'s initial weights into the model."""
        self.model.init_weights(split_seed(seed, k))

    @torch.no_grad()
    def _stacked(self, K: int, seed: int) -> Dict[str, torch.Tensor]:
        """{parameter name: (K, ...) stack of the members' initial
        values}."""
        named = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in named.items()}
        members = []
        for k in range(K):
            self._member_init(k, seed)
            members.append({n: p.detach().clone() for n, p in named.items()})
        for n, p in named.items():
            p.copy_(saved[n])
        return {n: torch.stack([m[n] for m in members]) for n in named}

    @torch.no_grad()
    def _member_tree(self, params: Dict[str, torch.Tensor], k: int) -> Dict:
        """Member ``k``'s parameters as a JAX-layout tree of numpy
        arrays."""
        named = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in named.items()}
        for n, p in named.items():
            p.copy_(params[n][k])
        tree = _numpy_tree(export_params(self.model))
        for n, p in named.items():
            p.copy_(saved[n])
        return tree

    @torch.no_grad()
    def _dropout_sites(self, bx) -> Dict[int, tuple]:
        """{site seed: the shape of its draws} from one training-mode
        forward of a batch."""
        sites = {}

        def record(seed, shape):
            sites[seed] = shape
            return torch.ones(shape, device=bx.device)
        with dropout_draws(record):
            self.model(bx)
        return sites

    def fit(self, x, y, lrs: Sequence[float], *, epochs: int = 5,
            batch_size: int = 32, seed: int = 0) -> Dict:
        from torch.func import functional_call, grad_and_value, vmap
        model, loss_fn = self.model, self.loss_fn
        dev = next(model.parameters()).device
        K = len(lrs)
        x, y = _as_tensor(x, dev), _as_tensor(y, dev)
        params = self._stacked(K, seed)
        m_state = {n: torch.zeros_like(p) for n, p in params.items()}
        v_state = {n: torch.zeros_like(p) for n, p in params.items()}
        lr_vec = torch.tensor(list(lrs), dtype=torch.float32, device=dev)
        n = x.shape[0]
        steps = max(n // batch_size, 1)
        rows = min(batch_size, n)
        was_training = model.training
        model.train()
        model.seed_dropout(seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        try:
            sites = self._dropout_sites(x[:rows])

            def member_loss(p, bx, by, draws):
                with dropout_draws(lambda s, shape: draws[s]):
                    pred = functional_call(model, p, (bx,))
                return loss_fn(pred, by).mean()

            step_fn = vmap(grad_and_value(member_loss),
                           in_dims=(0, None, None, 0))
            b1 = torch.tensor(0.9, dtype=torch.float32, device=dev)
            b2 = torch.tensor(0.999, dtype=torch.float32, device=dev)
            t = torch.ones((), dtype=torch.float32, device=dev)
            history = []
            for _ in range(epochs):
                perm = torch.randperm(n, generator=gen, device=dev)
                perm = perm[:steps * batch_size]
                losses = []
                for s in range(steps):
                    idx = perm[s * batch_size:(s + 1) * batch_size]
                    draws = {site: torch.rand((K,) + shape, generator=gen,
                                              device=dev)
                             for site, shape in sites.items()}
                    grads, loss = step_fn(params, x[idx], y[idx], draws)
                    with torch.no_grad():
                        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                        for name, p in params.items():
                            g = grads[name]
                            m = 0.9 * m_state[name] + 0.1 * g
                            v = 0.999 * v_state[name] + 0.001 * g * g
                            lr = lr_vec.reshape((K,) + (1,) * (p.ndim - 1))
                            params[name] = p - lr * (m / c1) / (
                                torch.sqrt(v / c2) + 1e-8)
                            m_state[name], v_state[name] = m, v
                    t = t + 1.0
                    losses.append(loss.detach())
                history.append(torch.stack(losses).mean(0).cpu().numpy())
        finally:
            model.seed_dropout(None)
            model.train(was_training)

        final = history[-1]
        best = int(np.argmin(final))
        return {"losses": np.stack(history),          # (epochs, K)
                "final_losses": final, "best_index": best,
                "best_lr": float(lrs[best]),
                "best_params": self._member_tree(params, best),
                "population_size": K}
