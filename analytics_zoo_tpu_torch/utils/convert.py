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

Every dense ``W`` is (d_in, d_out) on both sides.  Leaves arrive as numpy
arrays (or anything ``np.asarray`` takes) or as torch tensors; nothing of
JAX is imported here.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers.core import Dense
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


def _copy_leaf(dst: torch.Tensor, leaf, path: str) -> None:
    src = leaf if isinstance(leaf, torch.Tensor) \
        else torch.tensor(np.asarray(leaf))
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


def _load_tree(own: Dict, tree, path: str) -> None:
    if not isinstance(tree, dict):
        raise TypeError(f"{path or '/'}: expected a dict subtree, got "
                        f"{type(tree).__name__}")
    for key in sorted(set(own) | set(tree)):
        at = f"{path}/{key}"
        if key not in own:
            raise KeyError(f"module has no parameter {at!r}")
        val = own[key]
        if key not in tree:
            if isinstance(val, Layer) and not val._tree():
                continue                  # a paramless layer
            raise KeyError(f"params tree lacks {at!r}")
        if isinstance(val, Layer):
            _load_layer(val, tree[key], at)
        elif isinstance(val, dict):
            _load_tree(val, tree[key], at)
        else:
            _copy_leaf(val, tree[key], at)


def _load_layer(layer: Layer, tree, path: str) -> None:
    if isinstance(layer, Dense) and isinstance(tree, dict):
        layer.adopt_leaves(tree)
    _load_tree(layer._tree(), tree, path)


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


def export_params(layer: Layer) -> Dict:
    """The layer's parameters as a JAX-layout tree of (detached) tensors —
    the input ``inference/quantize.quantize_params`` takes, and what the
    tests compare leaf by leaf with a JAX param tree after training."""

    def walk(own):
        return {k: walk(v._tree()) if isinstance(v, Layer)
                else walk(v) if isinstance(v, dict) else v.detach()
                for k, v in own.items()}
    return walk(layer._tree())
