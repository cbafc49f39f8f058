"""Global dtype policy.

Params live in `param_dtype` (float32); matmul inputs may be cast to
`compute_dtype` with float32 accumulation.  The policy is process-global so
every layer picks it up without per-layer plumbing; the serving path runs
in float32 (no casting), which is the default.
"""

from __future__ import annotations

import torch

_policy = {"compute": None, "param": torch.float32}


def set_policy(compute_dtype=None, param_dtype=torch.float32):
    """compute_dtype=None means no casting (pure float32)."""
    _policy["compute"] = compute_dtype or None
    _policy["param"] = param_dtype


def mixed_bf16():
    set_policy(torch.bfloat16, torch.float32)


def compute_dtype():
    return _policy["compute"]


def param_dtype():
    return _policy["param"]


def cast_compute(*tensors):
    """Cast tensors to the compute dtype (no-op when policy is unset)."""
    c = _policy["compute"]
    if c is None:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(c) if isinstance(t, torch.Tensor) else t
                for t in tensors)
    return out if len(out) > 1 else out[0]


def matmul(x, w, out_dtype):
    """``x @ w`` summed and returned in ``out_dtype``, as
    ``jnp.matmul(x, w, preferred_element_type=out_dtype)`` does: a bf16
    product is not rounded to bf16.  Widening the operands is exact, so the
    products and their f32 sums are the reference's."""
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))
