"""Helpers of the layer parity tests (``test_torch_port_layers_conv.py``,
``test_torch_port_layers_misc.py``, ``test_torch_port_mobilenet.py``):
one port layer against its JAX twin on the same numpy inputs and the same
weights (the port layer's own draw, exported in the JAX layout), forward
and gradients."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.nn.module import Layer
from analytics_zoo_tpu_torch.utils.convert import export_params

# f32 layers on both sides; only the summation order differs (XLA vs
# oneDNN / ATen); PERF.md's "Parity tolerances"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


@contextlib.contextmanager
def f32_policy():
    """Both packages at the f32 dtype policy the tolerances assume (each
    policy is process-global; a benchmark run in-process in the same
    worker may leave the JAX package's at bf16)."""
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    try:
        yield
    finally:
        jdtypes._policy.update(saved_j)
        tdtypes._policy.update(saved_t)


def to_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def tree_np(tree):
    """A tree of tensors (dicts, lists) as numpy leaves."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    return to_np(tree)


def params_np(layer):
    return tree_np(export_params(layer))


def live_leaves(layer, prefix=""):
    """{path: tensor} of the port layer's own parameter tensors, keyed as
    its JAX-layout tree (``_tree``, sub-layers walked)."""
    out = {}

    def walk(v, path):
        if isinstance(v, Layer):
            walk(v._tree(), path)
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{path}/{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{path}/{i}")
        else:
            out[path] = v
    walk(layer, prefix)
    return out


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _as_torch(x, grad):
    if isinstance(x, (list, tuple)):
        return [_as_torch(v, grad) for v in x]
    t = torch.from_numpy(np.array(x))
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _outs(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


def check_layer(tl, jl, x, *, params=None, tol=LAYER_TOL, grads=True,
                x_grad=True, seed=0):
    """Forward of the port layer ``tl`` (eval mode) and of the JAX layer
    ``jl`` (``call(params, x)``) on the numpy input ``x`` (an array or a
    list) within ``tol``, the node shape rule against the JAX output; with
    ``grads``, the gradients of Σ y·r (r seeded) with respect to every
    parameter and, with ``x_grad``, the float inputs.  ``params``: the
    JAX tree (default: the port layer's own, exported).  Returns the JAX
    output."""
    params = params_np(tl) if params is None else params
    want = jl.call(params, x)
    txs = _as_torch(x, grads and x_grad)
    got = tl(txs)
    w_outs, g_outs = _outs(want), _outs(got)
    assert len(w_outs) == len(g_outs)
    for w, g in zip(w_outs, g_outs):
        assert tuple(g.shape) == tuple(np.shape(w)), (g.shape, np.shape(w))
        np.testing.assert_allclose(to_np(g), np.asarray(w), **tol)
    if not grads:
        return want
    g = np.random.default_rng(seed + 1)
    rs = [g.normal(size=np.shape(w)).astype(np.float32) for w in w_outs]

    def loss(p, xv):
        ys = _outs(jl.call(p, xv))
        return sum(jnp.sum(y * r) for y, r in zip(ys, rs))
    argnums = (0, 1) if x_grad else (0,)
    jg = jax.grad(loss, argnums=argnums)(params, x)
    total = sum((o * torch.from_numpy(r)).sum() for o, r in zip(g_outs, rs))
    total.backward()
    live = live_leaves(tl)
    want_p = flat(tree_np(jg[0]))
    assert sorted(want_p) == sorted(live), (sorted(want_p), sorted(live))
    for path, leaf in live.items():
        np.testing.assert_allclose(to_np(leaf.grad), want_p[path], **tol,
                                   err_msg=path)
    if x_grad:
        jx = jg[1]
        tx = txs if isinstance(txs, list) else [txs]
        jxs = jx if isinstance(jx, (list, tuple)) else [jx]
        for t, w in zip(tx, jxs):
            if t.requires_grad:
                np.testing.assert_allclose(to_np(t.grad), np.asarray(w),
                                           **tol)
    return want
