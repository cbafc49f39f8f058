"""Quantization for the inference path — the JAX package's
``inference/quantize.py``.

**Weights (PTQ).**  Produces the leaves the fused-dequant kernels in
``ops/quant_matmul.py`` serve from, on the same recipe, numpy for numpy:

- **W8A8** (``bits=8``): symmetric per-output-channel int8 weights
  (``W_q = round(W / s_w)``, ``s_w = absmax_channel / 127``) plus a
  per-tensor activation scale ``s_x = a / 127`` from calibration.
- **W4A16** (``bits=4``): weight-only symmetric int4 with group-wise scales
  along K (``group_size`` rows per scale, normalized to
  ``ceil(K / ceil(K / group_size))``), nibble-packed two per byte.

Calibration (``calibrate``) runs batches through the model with forward
pre-hooks on every ``Dense`` and records each one's input absmax — or,
with ``percentile=p``, the p-th percentile of |x| — keyed by the layer's
PATH in the param tree (``outer/inner``), so two same-named layers in
different containers calibrate independently.  ``quantize_params`` works
on a JAX-layout param tree (``utils/convert.export_params``) and returns
one with quantized leaves, which ``utils/convert.load_jax_params`` loads
back (switching each ``Dense`` to its quantized form).  Only ``Dense`` is
quantized here; the conv entries come with the Conv slice.

**KV cache.**  int8 KV packing — the one pack/unpack contract shared by
the paged attention kernel (``ops/paged_attention.py``), the decode append
path (``models/textmodels.TransformerLM.decode_paged``) and the prefill
commit (``serving/generate.py``): symmetric int8 with one scale per
(block, head), scale = absmax / 127 floored at 1e-12, round half-to-even,
clip to ±127.

``torch.round`` rounds half to even like ``jnp.round``, so packed values
agree bitwise with the JAX package's for the same float inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn.layers.core import Dense

QUANTIZABLE = (Dense,)

# leaves the quantizer emits; weight-byte accounting and "already
# quantized" detection key off these
QUANT_LEAVES = ("W_q", "W_q4", "s_w", "s_g", "s_x")

# per-layer cap on the |x| sample kept for percentile calibration
_PCTL_SAMPLE = 8192


def _target_layers(model, params) -> List[Tuple[object, dict, str]]:
    """(layer, its params, path) for every quantizable layer, recursing
    into containers (``Sequential.layers_list``).  ``path`` is the
    slash-joined key chain inside ``params``."""
    out = []

    def walk(layer, p, path):
        if isinstance(layer, QUANTIZABLE) and isinstance(p, dict) \
                and ("W" in p or "W_q" in p or "W_q4" in p):
            out.append((layer, p, path or layer.name))
            return
        subs = getattr(layer, "layers_list", None)
        if subs:
            for sub in subs:
                if isinstance(p, dict) and sub.name in p:
                    walk(sub, p[sub.name],
                         f"{path}/{sub.name}" if path else sub.name)

    walk(model, params, "")
    return out


@torch.inference_mode()
def calibrate(model, calib_inputs,
              percentile: Optional[float] = None) -> Dict[str, float]:
    """Run ``calib_inputs`` (one batch or a list of batches) through the
    model, recording each quantizable layer's input magnitude.  Returns
    ``{layer_path: clip}``: the absmax, or with ``percentile=p`` the p-th
    percentile of |x| over the sweep (it can only tighten the absmax)."""
    from analytics_zoo_tpu_torch.utils.convert import export_params
    if percentile is not None and not (0.0 < float(percentile) <= 100.0):
        raise ValueError(f"percentile={percentile!r}: expected (0, 100]")
    records: Dict[str, float] = {}
    samples: Dict[str, List[np.ndarray]] = {}
    hooks = []

    def make_hook(path):
        def hook(_layer, args):
            ax = args[0].to(torch.float32).abs()
            records[path] = max(records.get(path, 0.0), float(ax.max()))
            if percentile is not None:
                flat = ax.reshape(-1)
                stride = max(1, flat.numel() // _PCTL_SAMPLE)
                kept = samples.setdefault(path, [])
                kept.append(flat[::stride][:_PCTL_SAMPLE].cpu().numpy())
                if sum(c.size for c in kept) > 4 * _PCTL_SAMPLE:
                    merged = np.concatenate(kept)
                    st = max(1, merged.size // _PCTL_SAMPLE)
                    kept[:] = [merged[::st][:_PCTL_SAMPLE]]
        return hook

    for layer, _, path in _target_layers(model, export_params(model)):
        hooks.append(layer.register_forward_pre_hook(make_hook(path)))
    try:
        batches = calib_inputs if isinstance(calib_inputs, list) \
            else [calib_inputs]
        dev = next(model.parameters()).device

        def to_dev(a):
            return torch.as_tensor(np.asarray(a)).to(dev)
        for xb in batches:
            model([to_dev(a) for a in xb] if isinstance(xb, (list, tuple))
                  else to_dev(xb))
    finally:
        for h in hooks:
            h.remove()
    if percentile is not None:
        for path, chunks in samples.items():
            clip = float(np.percentile(np.concatenate(chunks),
                                       float(percentile)))
            if clip > 0.0:
                records[path] = min(records[path], clip)
    return records


def _locate_holder(tree: dict, path: str):
    """The dict holding ``path``'s final segment, by the exact key chain."""
    segs = path.split("/")
    cur = tree
    for seg in segs[:-1]:
        cur = cur[seg]
    return cur, segs[-1]


def _quantize_w8(W: np.ndarray, a: float) -> dict:
    red = tuple(range(W.ndim - 1))   # all but the output-channel axis
    s_w = np.maximum(np.abs(W).max(axis=red), 1e-12) / 127.0
    W_q = np.clip(np.round(W / s_w), -127, 127).astype(np.int8)
    return {"W_q": W_q, "s_w": np.asarray(s_w, np.float32),
            "s_x": np.asarray(a / 127.0, np.float32)}


def _quantize_w4(W: np.ndarray, group_size: int) -> dict:
    """Symmetric int4 with group-wise scales along K; the requested group
    size is normalized to ``ceil(K / ceil(K / group_size))`` so it follows
    from the stored shapes alone."""
    from analytics_zoo_tpu_torch.ops.quant_matmul import pack_int4
    n = W.shape[-1]
    k = int(np.prod(W.shape[:-1]))
    W2 = W.reshape(k, n)
    g = max(1, -(-k // max(1, int(group_size))))
    gs = -(-k // g)
    s_rows = np.empty((g, n), np.float32)
    q = np.empty((k, n), np.int8)
    for i in range(g):
        lo, hi = i * gs, min((i + 1) * gs, k)
        s = np.maximum(np.abs(W2[lo:hi]).max(axis=0), 1e-12) / 7.0
        s_rows[i] = s
        q[lo:hi] = np.clip(np.round(W2[lo:hi] / s), -7, 7).astype(np.int8)
    return {"W_q4": pack_int4(q), "s_g": s_rows}


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def quantize_params(model, params, absmax: Dict[str, float], bits: int = 8,
                    group_size: int = 64):
    """A new param tree with quantizable layers' weights replaced by their
    quantized leaves (numpy):

    - ``bits=8``: ``{W_q, s_w, s_x, b?}`` — layers ``absmax`` never saw
      stay float;
    - ``bits=4``: ``{W_q4, s_g, b?}`` — weight-only, every quantizable
      layer converts (``absmax`` is not consulted).

    ``absmax`` keys are layer paths (see :func:`calibrate`); bare layer
    names are accepted for top-level layers, where path == name."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits!r}: expected 8 or 4")

    def copy_tree(p):
        return {k: copy_tree(v) if isinstance(v, dict) else v
                for k, v in p.items()}

    qp = copy_tree(params)
    for layer, _, path in _target_layers(model, params):
        a = absmax.get(path, absmax.get(layer.name, 0.0))
        if bits == 8 and a <= 0.0:
            continue                     # never calibrated: leave in float
        holder, key = _locate_holder(qp, path)
        lp = holder[key]
        if "W" not in lp:
            if bits == 8 and "W_q" in lp and a > 0.0:
                # already int8: re-calibration refreshes the activation
                # scale
                lp["s_x"] = np.asarray(a / 127.0, np.float32)
            continue                     # already quantized otherwise
        W = _as_numpy(lp["W"]).astype(np.float32)
        new = _quantize_w8(W, a) if bits == 8 \
            else _quantize_w4(W, group_size)
        if "b" in lp:
            new["b"] = lp["b"]
        holder[key] = new
    return qp


def quantize(model, calib_inputs, bits: int = 8, group_size: int = 64,
             percentile: Optional[float] = None):
    """calibrate + quantize_params on ``model``'s own weights, loaded back
    into it (quantized ``Dense`` layers).  ``calib_inputs``: a batch or a
    list of batches, or None for the weight-only ``bits=4`` mode.  Returns
    the quantized param tree."""
    from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                       load_jax_params)
    if hasattr(calib_inputs, "batches"):
        raise NotImplementedError(
            "calibration from a FeatureSet comes with feature/ (ROADMAP "
            "queue 1, item 6); pass a batch or a list of batches")
    if calib_inputs is None:
        if bits == 8:
            raise ValueError("int8 quantization needs calibration inputs "
                             "(activation scales); bits=4 is weight-only")
        absmax: Dict[str, float] = {}
    else:
        absmax = calibrate(model, calib_inputs, percentile=percentile)
    qp = quantize_params(model, export_params(model), absmax, bits=bits,
                         group_size=group_size)
    load_jax_params(model, qp)
    return qp


# -- introspection / accounting ------------------------------------------------

def _leaf_items(params, prefix=""):
    for k in sorted(params):
        v = params[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaf_items(v, path)
        else:
            yield path, v


def quantized_bits(params) -> int:
    """0 (float), 8 or 4 — what the param tree serves with.  Mixed trees
    report the SMALLEST width present."""
    bits = 0
    for path, _ in _leaf_items(params):
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "W_q4":
            return 4
        if leaf == "W_q":
            bits = 8
    return bits


def weight_bytes(params) -> int:
    """Bytes of parameters read from device memory per forward pass: every
    leaf of the tree (weights, scales, biases) at its stored dtype."""
    total = 0
    for _, leaf in _leaf_items(params):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.size(leaf)) * np.asarray(leaf).dtype.itemsize
    return total


# -- int8 KV-cache packing -----------------------------------------------------

def kv_pack_int8(x: torch.Tensor):
    """Quantize KV block(s) ``x`` (..., block_len, heads, head_dim) f32 ->
    ``(q int8 same shape, scale f32 (..., heads))``.  The scale is the
    per-(block, head) absmax over the (block_len, head_dim) axes — padded
    or unwritten positions must arrive ZEROED so they cannot inflate it
    (zeros quantize to zero exactly at any scale)."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=(-3, -1))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def kv_unpack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_pack_int8`: int8 blocks + per-(block, head)
    scales -> f32 values (exact for zeros; |err| <= scale/2 elsewhere)."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None, :, None]
