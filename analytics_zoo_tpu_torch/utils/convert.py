"""Weights from the JAX package's param pytrees into the port's modules.

Two model families, two tree layouts, both loaded leaf by leaf with
checked shapes (a missing or extra leaf raises):

- ``TransformerLM``::

      {"embed": (V, H), "pos": (max_len, H), "ln_f": {"g", "b"},
       "blocks": [{"ln1", "qkv", "proj", "ln2", "fc1", "fc2"}, ...]}

- the layer IR (``nn/``): every ``Layer`` names its subtree through
  ``_tree()``, keyed as the JAX package's ``build`` keys it —
  ``Sequential`` ``{layer_name: subtree}``, ``TransformerLayer`` ``wte``,
  ``wpe`` and ``{block_name: {attn: {qkv, out}, ffn: {fc, proj}, ln1,
  ln2}}``, ``LayerNorm`` ``{gamma, beta}``, ``Dense`` float ``{W, b}``,
  int8 ``{W_q, s_w, s_x, b}`` or int4 ``{W_q4, s_g, b}``.  Sub-trees are
  matched by KEY, never by order (JAX flattens dicts in sorted key order,
  so ``dense_10`` comes before ``dense_9``).  A float ``Dense`` given a
  quantized leaf set switches to that form (``Dense.adopt_leaves``).
  The graph ``Model`` keys its tree ``{layer_name: subtree}`` too,
  ``Convolution2D`` ``{W (kh, kw, cin, cout), b}`` (int8 ``{W_q, s_w,
  s_x, b}``, int4 ``{W_q4, s_g, b}``, switched to as ``Dense`` is:
  ``_ConvND.adopt_leaves``), ``BatchNormalization`` ``{gamma, beta}``,
  SSD's ``NormalizeScale`` ``{gamma (C,)}``,
  ``Embedding`` ``{E (input_dim, output_dim)}``, the recurrent layers
  (``nn/layers/recurrent.py``) ``{Wx, Wh, b}`` (``GRU(reset_after=True)``
  adds ``br``; ConvLSTM ``Wx`` (k…, C, 4F), ``Wh`` (k…, F, 4F)),
  ``Bidirectional`` ``{fwd, bwd}``, ``TimeDistributed`` ``{inner}`` (its
  state ``{inner}`` too), ``Highway`` ``{W, Wt, b, bt}``, ``Seq2seq``
  ``{embed, encoder: [{Wx, Wh, b}, ...], decoder: [...], out: {W, b}}``
  with ``bridge: {W}`` for a dense bridge (a list subtree is matched by
  index, each index a key); a layer without
  parameters (``Flatten``, ``Merge``, ``Lambda``, the shape layers) has
  the empty subtree ``{}``.
- the layer IR's state tree (the JAX ``model._state``): the same layout
  over ``_state_tree()``, ``BatchNormalization`` ``{mean, var}``
  (``load_jax_state``, ``export_state``).

Every dense ``W`` is (d_in, d_out) on both sides.  Leaves arrive as numpy
arrays (or anything ``np.asarray`` takes) or as torch tensors; nothing of
JAX is imported here.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.module import Layer

_BLOCK_KEYS = ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")


def _lm_leaves(params: Dict) -> Iterator[Tuple[str, object]]:
    """(module attribute path, leaf) for every leaf of a TransformerLM
    param pytree."""
    yield "embed", params["embed"]
    yield "pos", params["pos"]
    for k in ("g", "b"):
        yield f"ln_f.{k}", params["ln_f"][k]
    for i, blk in enumerate(params["blocks"]):
        for name in _BLOCK_KEYS:
            for k, leaf in blk[name].items():
                yield f"blocks.{i}.{name}.{k}", leaf


def _host_view(leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor over the same memory.  The loader only
    reads it (``copy_`` into the parameter), so a read-only leaf mapped
    from a weight store is read once, straight into the parameter's own
    storage: on the card, host pages to the device with no host copy
    between; on the CPU, a private copy the store never sees written."""
    a = np.asarray(leaf)
    if any(s < 0 for s in a.strides):
        a = a.copy()
    with warnings.catch_warnings():
        # torch warns that writes through a read-only array's tensor are
        # undefined; this one is never written
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a)


def _copy_leaf(dst: torch.Tensor, leaf, path: str) -> None:
    src = leaf if isinstance(leaf, torch.Tensor) else _host_view(leaf)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    if src.dtype != dst.dtype and not (src.is_floating_point()
                                       and dst.is_floating_point()):
        raise TypeError(f"{path}: dtype {src.dtype} cannot load into "
                        f"{dst.dtype}")
    dst.copy_(src)


def _load_lm(module: TransformerLM, params: Dict) -> None:
    own = dict(module.named_parameters())
    seen = set()
    for path, leaf in _lm_leaves(params):
        if path not in own:
            raise KeyError(f"module has no parameter {path!r}")
        _copy_leaf(own[path], np.asarray(leaf, dtype=np.float32), path)
        seen.add(path)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"params pytree lacks {missing}")


def _params_of(layer: Layer) -> Dict:
    return layer._tree()


def _state_of(layer: Layer) -> Dict:
    return layer._state_tree()


def _load_value(val, leaf, path: str, subtree) -> None:
    if isinstance(val, Layer):
        _load_layer(val, leaf, path, subtree)
    elif isinstance(val, dict):
        _load_tree(val, leaf, path, subtree)
    elif isinstance(val, (list, tuple)):
        _load_list(val, leaf, path, subtree)
    else:
        _copy_leaf(val, leaf, path)


def _load_list(own, tree, path: str, subtree) -> None:
    """A list subtree (``Seq2seq``'s per-layer ``encoder`` / ``decoder``
    stacks): its index is its key, as in the JAX tree's flattening."""
    if not isinstance(tree, (list, tuple)) or len(tree) != len(own):
        raise ValueError(f"{path}: expected a list of {len(own)} subtrees, "
                         f"got {type(tree).__name__} of "
                         f"{len(tree) if hasattr(tree, '__len__') else '?'}")
    for i, (val, leaf) in enumerate(zip(own, tree)):
        _load_value(val, leaf, f"{path}/{i}", subtree)


def _load_tree(own: Dict, tree, path: str, subtree=_params_of) -> None:
    """Copy ``tree`` into ``own`` key by key; a sub-``Layer``'s own tree
    is ``subtree(layer)``."""
    if not isinstance(tree, dict):
        raise TypeError(f"{path or '/'}: expected a dict subtree, got "
                        f"{type(tree).__name__}")
    kind, noun = ("params", "parameter") if subtree is _params_of \
        else ("state", "state leaf")
    for key in sorted(set(own) | set(tree)):
        at = f"{path}/{key}"
        if key not in own:
            raise KeyError(f"module has no {noun} {at!r}")
        val = own[key]
        if key not in tree:
            if isinstance(val, Layer) and not subtree(val):
                continue                  # a layer with no leaves here
            raise KeyError(f"{kind} tree lacks {at!r}")
        _load_value(val, tree[key], at, subtree)


def _load_layer(layer: Layer, tree, path: str, subtree=_params_of) -> None:
    """A layer given a param leaf set first switches to the form it names
    (``Dense.adopt_leaves``, ``_ConvND.adopt_leaves``)."""
    if subtree is _params_of and isinstance(tree, dict) \
            and hasattr(layer, "adopt_leaves"):
        layer.adopt_leaves(tree)
    _load_tree(subtree(layer), tree, path, subtree)


def load_jax_params(module: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Copy a JAX param pytree into ``module`` (in place, on the module's
    device): a ``TransformerLM`` tree, or the tree of a layer-IR ``Layer``
    (a ``Sequential`` takes ``{layer_name: subtree}``)."""
    with torch.no_grad():
        if isinstance(module, TransformerLM):
            _load_lm(module, params)
        elif isinstance(module, Layer):
            _load_layer(module, params, "")
        else:
            raise TypeError(f"cannot load a JAX param tree into "
                            f"{type(module).__name__}")
    return module


def load_jax_state(module: Layer, state: Dict) -> Layer:
    """Copy a JAX state tree (the JAX ``model._state``: BatchNorm
    ``{mean, var}`` under each layer's name, ``{}`` for stateless layers)
    into the layer IR's state buffers, in place."""
    if not isinstance(module, Layer):
        raise TypeError(f"cannot load a JAX state tree into "
                        f"{type(module).__name__}")
    with torch.no_grad():
        _load_layer(module, state, "", _state_of)
    return module


def _export(layer: Layer, subtree) -> Dict:
    def walk(v):
        if isinstance(v, Layer):
            return walk(subtree(v))
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return v.detach()
    return walk(subtree(layer))


def export_params(layer: Layer) -> Dict:
    """The layer's parameters as a JAX-layout tree of (detached) tensors —
    the input ``inference/quantize.quantize_params`` takes, and what the
    tests compare leaf by leaf with a JAX param tree after training."""
    return _export(layer, _params_of)


def export_state(layer: Layer) -> Dict:
    """The layer's state buffers as a JAX-layout state tree."""
    return _export(layer, _state_of)
