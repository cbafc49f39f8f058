"""Optimizers and LR schedules with Keras/zoo names — the JAX package's
``nn/optimizers.py``, with optax's exact semantics.

The JAX package builds every optimizer as an optax chain.  The port keeps
that shape: a ``Transform`` turns a list of gradients into a list of
updates (``init(params) -> state``, ``update(grads, state, params) ->
updates``), ``Chain`` composes them, and ``apply_updates`` adds the result
to the parameters.  Every update is written with ``torch._foreach_*`` ops
over the whole parameter list, on the parameters' device.  Where optax
differs from ``torch.optim``, optax holds:

- a schedule is read at the step count *before* the update
  (``optax.scale_by_schedule``), so a warm-up from 0 gives the first step
  a learning rate of 0;
- ``optax.adamw`` decays every parameter, biases and LayerNorm included,
  by ``lr * weight_decay * p``, and adds it to the Adam direction before
  the learning rate scales both;
- ``optax.clip_by_global_norm`` scales by ``max_norm / |g|`` only when
  ``|g| >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- Adam's bias corrections use the step count after the update.

Step counts and schedules live on the host (Python ints and floats): an
update reads nothing back from the device.  The numbers an update takes
from them (a learning rate, Adam's bias corrections) are its *step
scalars*: ``step_scalars(state)`` advances the counts and returns them,
``apply(grads, state, params, scalars)`` does the tensor work.  ``update``
is the two in turn, with the scalars as Python floats.  A caller that
captures several updates in one CUDA graph hands ``apply`` 0-dim device
tensors instead, refilled with each replay's ``step_scalars`` before it
runs: a float baked into a graph would freeze the step count.  The same
value as a float32 tensor gives the same update: bit for bit on the CPU,
and on the H100 to within a last f32 bit of some elements (the foreach
kernels' Tensor-scalar and Python-scalar paths).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]
LR = Union[float, Schedule]


# -- schedules (optax semantics; a schedule maps a step count to a value) ----

def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        c = min(max(count, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    return _polynomial(init_value, end_value, 1, transition_steps)


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, sch in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sch(step - boundary)
        return out
    return schedule


def poly(base_lr: float, power: float, max_iteration: int) -> Schedule:
    """Polynomial decay (BigDL SGD.Poly)."""
    return _polynomial(base_lr, 0.0, power, max_iteration)


def warmup(base_lr: float, warmup_steps: int, delta: float) -> Schedule:
    """Linear warmup adding ``delta`` per step (Optim.scala Warmup)."""
    return _linear(base_lr, base_lr + warmup_steps * delta, warmup_steps)


def sequential_schedule(schedules: Sequence[Schedule],
                        boundaries: Sequence[int]) -> Schedule:
    """Chain schedules at step boundaries (Optim.scala
    SequentialSchedule)."""
    return _join(list(schedules), list(boundaries))


def warmup_poly(base_lr: float, warmup_steps: int, total_steps: int,
                power=1.0) -> Schedule:
    """Warmup from 0, then polynomial decay to 0."""
    return _join([_linear(0.0, base_lr, warmup_steps),
                  _polynomial(base_lr, 0.0, power,
                              max(1, total_steps - warmup_steps))],
                 [warmup_steps])


def exponential_decay(base_lr, decay_rate, decay_steps,
                      staircase=False) -> Schedule:
    if decay_steps <= 0 or decay_rate == 0:
        return lambda count: base_lr

    def schedule(count):
        p = count / decay_steps
        if staircase:
            p = math.floor(p)
        return base_lr if count <= 0 else base_lr * decay_rate ** p
    return schedule


def _keras_decay(lr: float, decay: float) -> Schedule:
    return lambda step: lr / (1.0 + decay * step)


# -- transformations ------------------------------------------------------------

Tensors = List[torch.Tensor]


class Transform:
    """One optax ``GradientTransformation`` over a list of tensors.
    ``apply`` may change its state and the gradients it is given in
    place; the updates it returns never alias the state.  ``n_scalars``
    is the length of ``step_scalars``' list."""

    n_scalars = 0

    def init(self, params: Tensors) -> Dict:
        return {}

    def step_scalars(self, state: Dict) -> List[float]:
        """The host numbers one update reads, its step counts advanced."""
        return []

    def apply(self, grads: Tensors, state: Dict, params: Tensors,
              scalars: Sequence) -> Tensors:
        raise NotImplementedError

    def update(self, grads: Tensors, state: Dict, params: Tensors
               ) -> Tensors:
        return self.apply(grads, state, params, self.step_scalars(state))


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


class Chain(Transform):
    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    @property
    def n_scalars(self):
        return sum(t.n_scalars for t in self.transforms)

    def init(self, params):
        return {"inner": [t.init(params) for t in self.transforms]}

    def step_scalars(self, state):
        return [v for t, s in zip(self.transforms, state["inner"])
                for v in t.step_scalars(s)]

    def apply(self, grads, state, params, scalars):
        i = 0
        for t, s in zip(self.transforms, state["inner"]):
            grads = t.apply(grads, s, params, scalars[i:i + t.n_scalars])
            i += t.n_scalars
        return grads


class ScaleByAdam(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.nesterov = nesterov
        self.n_scalars = 3 if nesterov else 2

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def step_scalars(self, state):
        """The bias corrections at the count after this update: of mu
        (Nesterov: of mu and of the gradient), then of nu."""
        b1, b2 = self.b1, self.b2
        state["count"] += 1
        c = state["count"]
        if self.nesterov:
            return [(1 - b1 ** (c + 1)) / b1, (1 - b1 ** c) / (1 - b1),
                    1 - b2 ** c]
        return [1 - b1 ** c, 1 - b2 ** c]

    def apply(self, grads, state, params, scalars):
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        if self.nesterov:
            mu_hat = torch._foreach_div(mu, scalars[0])
            torch._foreach_add_(mu_hat, torch._foreach_div(grads,
                                                           scalars[1]))
        else:
            mu_hat = torch._foreach_div(mu, scalars[0])
        den = torch._foreach_div(nu, scalars[-1])
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        return mu_hat


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def apply(self, grads, state, params, scalars):
        torch._foreach_add_(grads, params, alpha=self.weight_decay)
        return grads


class ScaleByLearningRate(Transform):
    """``-lr * updates``; a schedule is read at its own count before the
    increment (``optax.scale_by_schedule``)."""

    n_scalars = 1

    def __init__(self, lr: LR):
        self.lr = lr

    def init(self, params):
        return {"count": 0}

    def step_scalars(self, state):
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        state["count"] += 1
        return [-float(lr)]

    def apply(self, grads, state, params, scalars):
        torch._foreach_mul_(grads, scalars[0])
        return grads


class Trace(Transform):
    """Momentum: ``t = g + decay * t``; updates ``t`` (or
    ``g + decay * t`` with Nesterov)."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {"trace": _zeros(params)}

    def apply(self, grads, state, params, scalars):
        tr = state["trace"]
        torch._foreach_mul_(tr, self.decay)
        torch._foreach_add_(tr, grads)
        if self.nesterov:
            return torch._foreach_add(grads, tr, alpha=self.decay)
        return [t.clone() for t in tr]


class ScaleByRms(Transform):
    def __init__(self, decay=0.9, eps=1e-8, initial_scale=0.0):
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale

    def init(self, params):
        return {"nu": [torch.full_like(p, self.initial_scale)
                       for p in params]}

    def apply(self, grads, state, params, scalars):
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        return scale


class ScaleByRss(Transform):
    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.init_value, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {"sum_of_squares": [torch.full_like(p, self.init_value)
                                   for p in params]}

    def apply(self, grads, state, params, scalars):
        sos = state["sum_of_squares"]
        torch._foreach_addcmul_(sos, grads, grads)
        return [torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * g
                for s, g in zip(sos, grads)]


class ScaleByAdadelta(Transform):
    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def apply(self, grads, state, params, scalars):
        rho, eps = self.rho, self.eps
        e_g, e_x = state["e_g"], state["e_x"]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(num, grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, num, num, value=1 - rho)
        return num


class ScaleByAdamax(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    n_scalars = 1

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def step_scalars(self, state):
        state["count"] += 1
        return [1 - self.b1 ** state["count"]]

    def apply(self, grads, state, params, scalars):
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        absg = torch._foreach_abs(grads)
        torch._foreach_add_(absg, self.eps)
        torch._foreach_maximum_(nu, absg)
        out = torch._foreach_div(mu, scalars[0])
        torch._foreach_div_(out, nu)
        return out


class Clip(Transform):
    """Each element clipped to [-max_delta, max_delta] (``optax.clip``)."""

    def __init__(self, max_delta: float):
        self.max_delta = max_delta

    def apply(self, grads, state, params, scalars):
        torch._foreach_clamp_min_(grads, -self.max_delta)
        torch._foreach_clamp_max_(grads, self.max_delta)
        return grads


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``grads``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class ClipByGlobalNorm(Transform):
    """``g / |g| * max_norm`` for every leaf when the global norm
    ``|g| >= max_norm``, else ``g`` unchanged (``optax.clip_by_global_norm``:
    no epsilon).  The decision stays on the device.  ``reduce_sq``, set by
    a sharded fit, sums the leaves' squared norms across the ranks that
    hold parts of them."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm
        self.reduce_sq: Optional[Callable] = None

    def apply(self, grads, state, params, scalars):
        if not grads:
            return grads
        if self.reduce_sq is None:
            norm = global_norm(grads)
        else:
            norm = torch.sqrt(self.reduce_sq(
                [n * n for n in torch._foreach_norm(grads)]))
        keep = norm < self.max_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, torch.full_like(
            norm, self.max_norm)))
        return grads


def transforms(opt: Transform):
    """``opt`` and every transform chained inside it."""
    yield opt
    for t in getattr(opt, "transforms", ()):
        yield from transforms(t)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p += u`` for every parameter (``optax.apply_updates``), in
    place."""
    torch._foreach_add_(params, updates)


# -- optimizers -------------------------------------------------------------------

def SGD(lr=0.01, momentum=0.0, decay=0.0, nesterov=False, schedule=None):
    lr_s = schedule or (_keras_decay(lr, decay) if decay else lr)
    if momentum:
        return Chain(Trace(momentum, nesterov), ScaleByLearningRate(lr_s))
    return Chain(ScaleByLearningRate(lr_s))


def Adam(lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8, decay=0.0,
         schedule=None):
    """Keras-semantics Adam: lr decays as lr/(1+decay*t), bias-corrected
    moments."""
    lr_s = schedule or (_keras_decay(lr, decay) if decay else lr)
    return Chain(ScaleByAdam(beta_1, beta_2, epsilon),
                 ScaleByLearningRate(lr_s))


def AdamWeightDecay(lr=0.001, warmup_portion=-1.0, total: int = -1,
                    schedule_name="linear", beta_1=0.9, beta_2=0.999,
                    epsilon=1e-6, weight_decay=0.01):
    """BERT AdamW: decoupled weight decay on every parameter, linear warmup
    for ``warmup_portion * total`` steps, then linear decay to zero."""
    if total > 0:
        w = int(max(0, warmup_portion) * total)
        lr_s = _join([_linear(0.0, lr, max(1, w)),
                      _linear(lr, 0.0, max(1, total - w))], [w])
    else:
        lr_s = lr
    return Chain(ScaleByAdam(beta_1, beta_2, epsilon),
                 AddDecayedWeights(weight_decay), ScaleByLearningRate(lr_s))


def RMSprop(lr=0.001, rho=0.9, epsilon=1e-8):
    return Chain(ScaleByRms(rho, epsilon), ScaleByLearningRate(lr))


def Adagrad(lr=0.01):
    return Chain(ScaleByRss(0.1, 1e-7), ScaleByLearningRate(lr))


def Adadelta(lr=1.0, rho=0.95, epsilon=1e-8):
    return Chain(ScaleByAdadelta(rho, epsilon), ScaleByLearningRate(lr))


def Adamax(lr=0.002, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
    return Chain(ScaleByAdamax(beta_1, beta_2, epsilon),
                 ScaleByLearningRate(lr))


def Nadam(lr=0.002, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
    return Chain(ScaleByAdam(beta_1, beta_2, epsilon, nesterov=True),
                 ScaleByLearningRate(lr))


def Ftrl(lr=0.5):
    """SGD, as in the JAX package (its Ftrl is an SGD placeholder)."""
    return SGD(lr)


_OPTIMIZERS = {
    "sgd": SGD, "adam": Adam, "rmsprop": RMSprop, "adagrad": Adagrad,
    "adadelta": Adadelta, "adamax": Adamax, "nadam": Nadam,
    "adamweightdecay": AdamWeightDecay,
}


def get(name):
    """Resolve an optimizer by Keras name, or take a ``Transform``."""
    if isinstance(name, Transform):
        return name
    if isinstance(name, str):
        key = name.lower()
        if key in _OPTIMIZERS:
            return _OPTIMIZERS[key]()
    raise ValueError(f"unknown optimizer {name!r}")


def with_gradient_clipping(opt: Transform, clip_norm: Optional[float] = None,
                           clip_value: Optional[float] = None) -> Transform:
    """Constant clipping, then L2 global-norm clipping, then ``opt``."""
    chain = []
    if clip_value is not None:
        chain.append(Clip(clip_value))
    if clip_norm is not None:
        chain.append(ClipByGlobalNorm(clip_norm))
    return Chain(*chain, opt)
