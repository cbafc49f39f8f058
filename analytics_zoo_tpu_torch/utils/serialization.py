"""Pytree persistence (weights save/load) — the JAX package's
``utils/serialization.py`` over nested dicts and lists, without
``jax.tree_util``.

Reference parity: BigDL module serialization used by ``Net.load`` /
``saveModel`` (pipeline/api/Net.scala:103-277).  Format: a single .npz
holding the tree's leaves keyed by their path, the keys joined with
``/`` (a list's index is its key), as JAX's ``tree_flatten_with_path``
names them: dict keys in sorted order, ``None`` and empty dicts give no
leaf.  So a file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def _leaf_array(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):                       # a torch tensor
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) for every leaf, in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(
                tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(
                v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def save_pytree(path: str, tree) -> None:
    flat = {k: _leaf_array(v) for k, v in _flatten_with_paths(tree)}
    np.savez(path, **flat)


def _restore(like, flat: Dict[str, np.ndarray], prefix: str, path: str):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _restore(v, flat, f"{prefix}/{k}" if prefix else str(k),
                            path) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_restore(v, flat, f"{prefix}/{i}" if prefix else str(i), path)
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    if prefix not in flat:
        raise KeyError(f"missing leaf {prefix!r} in {path}")
    return flat[prefix]


def load_pytree(path: str, like=None):
    """Load a pytree.  If ``like`` (a template tree) is given, leaves are
    restored into its exact structure (a missing leaf raises
    ``KeyError``); otherwise a nested dict keyed by path segments is
    returned."""
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as zf:
        flat = {k: zf[k] for k in zf.files}
    if like is not None:
        return _restore(like, flat, "", path)
    nested: dict = {}
    for key, val in flat.items():
        cur = nested
        parts = key.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = val
    return nested
