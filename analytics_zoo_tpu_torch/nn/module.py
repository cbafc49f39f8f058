"""Layer base for the port — the Keras-style layer IR.

The JAX package's ``Layer`` is a pure recipe — ``build(rng, shape) ->
params`` and ``call(params, x)`` — whose params are pytrees held outside
it, with shapes inferred by ``jax.eval_shape``.  In PyTorch a module OWNS
its parameters, so the port's ``Layer`` is an ``nn.Module``:

- ``name`` — auto-generated exactly as the JAX package's ``_auto_name``
  (``<classname>_<n>``, one counter per class), because the JAX param
  trees are keyed by layer names and ``utils/convert.load_jax_params``
  matches them by name.
- ``input_shape`` — declared at construction (batch axis excluded, Keras
  style).  A layer with a declared shape creates its parameters at once;
  otherwise its container builds it when the shape is known
  (``Sequential.add``).  Shapes follow from ``compute_output_shape``, one
  rule per layer, in place of ``jax.eval_shape``.
- parameters are drawn at build from a ``torch.Generator`` seeded by the
  layer's name; ``init_weights(seed)`` re-draws a whole model from one
  seeded generator, in layer order (the JAX ``init_weights(rng)``).
- ``param_count`` and ``_tree`` — the layer's parameters in the JAX
  package's tree layout (keys as in its ``build``), sub-layers left as
  ``Layer`` objects for ``utils/convert`` to walk.
- state — the JAX ``init_state`` / ``apply(params, state, ...)`` pair
  (BatchNorm's moving statistics).  Here state is registered buffers,
  updated in place by a forward in training mode; ``_state_tree`` lays
  them out as the JAX package's state tree, keyed as its
  ``init_state``.
- graph tracing — calling a layer on a ``SymTensor`` (``nn/graph.py``)
  records a node of a graph ``Model`` instead of computing.
- dropout randomness — the JAX ``apply(..., training, rng)`` splits one
  key per sub-layer (``split_rng``).  Here ``seed_dropout(seed)`` hands
  every sub-layer its own seed, split the same way, before a training
  step; each dropout site draws from a ``torch.Generator`` seeded with
  its layer's seed.  A layer with no seed drops nothing, as a JAX layer
  given ``rng=None`` does.

``forward`` takes the place of ``call``; ``nn.Module.train()`` /
``eval()`` take the place of the ``training`` flag.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import math
import threading
import zlib
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

Shape = Tuple[Optional[int], ...]

_name_counters: Dict[str, "itertools.count"] = defaultdict(itertools.count)


def _auto_name(cls_name: str) -> str:
    return f"{cls_name.lower()}_{next(_name_counters[cls_name])}"


def to_shape(s) -> Shape:
    if isinstance(s, int):
        return (s,)
    return tuple(s)


class Layer(nn.Module):
    """Base class for the port's layers and models: subclasses create their
    parameters in ``build`` (or in ``__init__`` when their shapes follow
    from hyper-parameters alone), fill them in ``reset_parameters`` and
    implement ``forward``."""

    def __init__(self, input_shape=None, name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        self._declared_input_shape = (
            None if input_shape is None else to_shape(input_shape))
        self.built = False
        # the JAX package's layers run with training=False unless told
        # otherwise; nn.Module starts in training mode
        self.training = False
        self.dropout_seed: Optional[int] = None

    # -- to be overridden ----------------------------------------------------
    def build(self, input_shape) -> None:
        """Create parameters for ``input_shape`` (batch axis excluded)."""

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw the parameters' values from ``gen``."""

    def compute_output_shape(self, input_shape):
        return input_shape

    def _tree(self) -> Dict:
        """This layer's parameters keyed as in the JAX package's param
        tree; values are tensors, nested dicts or sub-``Layer``s."""
        return {}

    def _state_tree(self) -> Dict:
        """This layer's state buffers keyed as in the JAX package's state
        tree (its ``init_state``); values as in ``_tree``."""
        return {}

    def __call__(self, *args, **kwargs):
        """A ``SymTensor`` (or a list of them) records a graph node
        (``nn/graph.trace_call``); tensors run ``forward``."""
        from analytics_zoo_tpu_torch.nn.graph import is_symbolic, trace_call
        if len(args) == 1 and not kwargs and is_symbolic(args[0]):
            return trace_call(self, args[0])
        return super().__call__(*args, **kwargs)

    # -- build + init ----------------------------------------------------------
    def ensure_built(self, input_shape) -> "Layer":
        """Build for ``input_shape`` once, with values drawn from a
        generator seeded by the layer's name."""
        if not self.built:
            self.build(input_shape)
            with torch.no_grad():
                self.reset_parameters(torch.Generator().manual_seed(
                    zlib.crc32(self.name.encode())))
            self.built = True
        return self

    def _build_declared(self) -> None:
        """Subclasses call this at the end of ``__init__``."""
        if self._declared_input_shape is not None:
            self.ensure_built(self._declared_input_shape)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Layer":
        """Re-draw every parameter from one generator seeded with ``seed``
        (on the host, then copied to where the parameters live)."""
        self.reset_parameters(torch.Generator().manual_seed(int(seed)))
        return self

    def sublayers(self):
        """Direct sub-layers in registration order (through
        ``nn.ModuleList``s)."""
        for child in self.children():
            if isinstance(child, Layer):
                yield child
            elif isinstance(child, nn.ModuleList):
                yield from (c for c in child if isinstance(c, Layer))

    def train_seed(self, index: Optional[int] = None) -> Optional[int]:
        """The seed a dropout site of this layer draws from: ``None``
        outside training mode or with no seed, else the layer's seed (split
        by ``index`` for a layer with several sites)."""
        if not self.training or self.dropout_seed is None:
            return None
        return self.dropout_seed if index is None \
            else split_seed(self.dropout_seed, index)

    def seed_dropout(self, seed: Optional[int]) -> None:
        """Seed this layer's dropout and, split by position, its
        sub-layers' (sub-layer ``i`` gets ``split_seed(seed, i)``, as the
        JAX ``split_rng(rng, i)``).  ``None`` turns dropout off."""
        self.dropout_seed = seed
        for i, sub in enumerate(self.sublayers()):
            sub.seed_dropout(split_seed(seed, i))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def extra_repr(self) -> str:
        return f"name={self.name!r}"


def split_seed(seed: Optional[int], index: int) -> Optional[int]:
    """A sub-seed derived from ``(seed, index)`` (the JAX ``fold_in``);
    ``None`` passes through."""
    if seed is None:
        return None
    digest = hashlib.blake2b(f"{seed}/{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


_draw_source = threading.local()


@contextlib.contextmanager
def dropout_draws(source: Callable[[int, tuple], torch.Tensor]):
    """Inside the block (on this thread), every dropout site takes its
    uniform draws from ``source(seed, shape)`` in place of a generator
    seeded with its seed.  The population trainer draws its members'
    draws outside ``torch.func.vmap``, where no generator can be used,
    and hands each member its own slice through this."""
    prev = getattr(_draw_source, "fn", None)
    _draw_source.fn = source
    try:
        yield
    finally:
        _draw_source.fn = prev


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout: ``x / keep`` where a uniform draw from a generator
    seeded with ``seed`` is below ``keep = 1 - rate``, else 0 (the JAX
    ``where(bernoulli(rng, keep), x / keep, 0)``); the draws come from
    ``dropout_draws``' source inside its block."""
    keep = 1.0 - rate
    source = getattr(_draw_source, "fn", None)
    if source is not None:
        draw = source(seed, tuple(x.shape))
    else:
        draw = torch.rand(x.shape, generator=generator(seed, x.device),
                          device=x.device)
    return torch.where(draw < keep, x / keep, 0.0).to(x.dtype)


def initializer(init: str, gen: torch.Generator, shape, fan_in=None,
                fan_out=None) -> torch.Tensor:
    """Keras-1 style weight initializers (the reference's ``init=``
    strings), drawn on the host from ``gen``."""
    shape = tuple(shape)
    numel = math.prod(shape) if shape else 1
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else max(1, numel)
    if fan_out is None:
        fan_out = shape[-1] if len(shape) >= 2 else max(1, numel)

    def uniform(limit):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit

    if init in ("glorot_uniform", "xavier"):
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if init == "glorot_normal":
        return math.sqrt(2.0 / (fan_in + fan_out)) \
            * torch.randn(shape, generator=gen)
    if init in ("he_normal", "msra"):
        return math.sqrt(2.0 / fan_in) * torch.randn(shape, generator=gen)
    if init == "he_uniform":
        return uniform(math.sqrt(6.0 / fan_in))
    if init == "lecun_uniform":
        return uniform(math.sqrt(3.0 / fan_in))
    if init == "uniform":
        return uniform(0.05)
    if init in ("normal", "gaussian"):
        return 0.05 * torch.randn(shape, generator=gen)
    if init in ("zero", "zeros"):
        return torch.zeros(shape)
    if init in ("one", "ones"):
        return torch.ones(shape)
    if init == "orthogonal":
        return nn.init.orthogonal_(torch.empty(shape), generator=gen)
    raise ValueError(f"unknown initializer {init!r}")
