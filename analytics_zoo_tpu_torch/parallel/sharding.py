r"""Sharding plans — how a model's parameters lay out over the mesh; the
JAX package's ``parallel/sharding.py``.

A ``ShardingPlan`` maps parameter paths (regexes over the "layer/leaf"
paths of ``utils/convert.export_params``, the JAX param tree's layout) to
``PartitionSpec``\ s, so one plan's regexes hit the same leaves in both
packages::

    plan = ShardingPlan([
        (r".*_fc\d*/W$",  P(None, "model")),   # column-parallel
        (r".*_proj/W$",   P("model", None)),   # row-parallel
        (r".*embed.*/E$", P("model", None)),   # vocab-sharded embedding
    ])

The JAX Estimator places each leaf by its spec and GSPMD partitions the
matmuls.  The port has no GSPMD: ``plan.shard(model)`` leaves each rank
its own slice of every sharded leaf and puts each layer that owns one
into its parallel form (``Layer.shard_leaves``), which computes on the
slice with explicit collectives (``parallel/comm.py``): ``Dense``
column- or row-parallel, attention's fused ``qkv`` column-parallel over
heads (each rank runs the flash kernel on its own heads) with ``out``
row-parallel, the FFN's ``fc`` column- and ``proj`` row-parallel, an
embedding vocab-sharded (a masked lookup and an all-reduce), the MoE's
experts over ``expert`` and a pipeline's stages over ``pipe``.  A leaf
the plan shards where no layer knows how to compute on a slice raises,
naming the leaf; nothing is gathered quietly.  ``_fit`` is the JAX rule:
axes missing from the mesh or of size 1 drop, and a dimension an axis
does not divide is replicated, with one warning.

Axis names follow ``common/context.py``: data / model / pipe / seq /
expert.
"""

from __future__ import annotations

import logging
import re
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.context import (DATA_AXIS, MODEL_AXIS,
                                                    Mesh, P, PartitionSpec,
                                                    _world, get_context,
                                                    global_put, shard_slice)

logger = logging.getLogger(__name__)

# how a parallel form split one leaf: dimension ``dim`` over ``axis``,
# the dimension viewed as ``groups`` equal runs each split alike
Layout = namedtuple("Layout", "dim axis groups")


def _ndim(leaf) -> int:
    return leaf.ndim if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def leaf_paths(tree) -> List[Tuple[str, object]]:
    """Flatten a param tree into ("a/b/c", leaf) pairs, dict keys in
    sorted order and list entries by index (the JAX
    ``tree_flatten_with_path`` order).  A ``Layer`` is read through
    ``utils/convert.export_params``."""
    from analytics_zoo_tpu_torch.nn.module import Layer
    if isinstance(tree, Layer):
        from analytics_zoo_tpu_torch.utils.convert import export_params
        tree = export_params(tree)
    out = []

    def walk(v, path):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(v[k], f"{path}/{k}" if path else str(k))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{path}/{i}" if path else str(i))
        else:
            out.append((path, v))
    walk(tree, "")
    return out


def _layers(layer, prefix: str = ""):
    """(layer, path prefix, {relative path: own leaf}) for ``layer`` and
    every sub-layer, the leaves a layer holds itself (not through a
    sub-layer) keyed by their path under it."""
    from analytics_zoo_tpu_torch.nn.module import Layer
    own, subs = {}, []

    def visit(v, rel):
        if isinstance(v, Layer):
            subs.append((v, "/".join(p for p in (prefix, rel) if p)))
        elif isinstance(v, dict):
            for k in v:
                visit(v[k], f"{rel}/{k}" if rel else str(k))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                visit(x, f"{rel}/{i}" if rel else str(i))
        else:
            own[rel] = v
    visit(layer._tree(), "")
    yield layer, prefix, own
    for sub, p in subs:
        yield from _layers(sub, p)


def sharded(spec) -> bool:
    return any(a is not None for a in tuple(spec))


class ShardingPlan:
    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]],
                 default: PartitionSpec = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default
        # one-time divisibility-fallback warnings (see _fit)
        self._warned: set = set()

    def spec_for(self, path: str, leaf=None) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(path):
                if leaf is not None and len(spec) > _ndim(leaf):
                    continue  # rule doesn't fit this rank; keep looking
                return spec
        return self.default

    def _fit(self, spec: PartitionSpec, mesh: Mesh, shape,
             path: Optional[str] = None) -> PartitionSpec:
        """Drop axes missing from the mesh or sized 1; trim to the leaf's
        rank; replicate a dimension an axis does not divide, warning once
        per (leaf, axis)."""
        rank = len(shape)
        parts = list(spec) + [None] * (rank - len(spec))
        fitted = []
        for dim, ax in zip(shape, parts[:rank]):
            n = mesh.size(ax) if ax is not None else 1
            if ax is None or n == 1:
                fitted.append(None)
            elif dim % n != 0:
                key = (path, ax, dim, n)
                if key not in self._warned:
                    self._warned.add(key)
                    logger.warning(
                        "sharding plan: leaf %s dim %d is not divisible by "
                        "mesh axis %r (size %d); replicating that dimension "
                        "instead", path or "<unknown>", dim, ax, n)
                fitted.append(None)
            else:
                fitted.append(ax)
        while fitted and fitted[-1] is None:
            fitted.pop()
        return P(*fitted)

    def shardings(self, tree, mesh: Optional[Mesh] = None) -> Dict:
        """{path: fitted spec} over the tree's leaves."""
        mesh = mesh or get_context().mesh
        return {p: self._fit(self.spec_for(p, l), mesh, _shape(l), path=p)
                for p, l in leaf_paths(tree)}

    def shard(self, tree, mesh: Optional[Mesh] = None):
        """A ``Layer``: each rank keeps its own slice of every leaf the
        plan shards, and the layers owning them take their parallel form
        (in place; returns the layer).  A param tree: {path: this rank's
        contiguous slice of each leaf} (``global_put``)."""
        from analytics_zoo_tpu_torch.nn.module import Layer
        mesh = mesh or get_context().mesh
        if isinstance(tree, Layer):
            return parallelize(tree, self, mesh)
        return {p: global_put(l, self._fit(self.spec_for(p, l), mesh,
                                           _shape(l), path=p), mesh)
                for p, l in leaf_paths(tree)}


def parallelize(model, plan: ShardingPlan, mesh: Mesh):
    """Put ``model`` into the parallel form ``plan`` asks for on ``mesh``:
    each layer with a sharded leaf gets its fitted specs through
    ``shard_leaves(specs, mesh)``, which keeps this rank's slices and
    returns their ``Layout``\\ s.  The layouts, by full path, land in
    ``model.shard_layout``."""
    layouts: Dict[str, Layout] = {}
    for layer, prefix, own in list(_layers(model)):
        specs = {}
        for rel, leaf in own.items():
            full = f"{prefix}/{rel}" if prefix else rel
            specs[rel] = plan._fit(plan.spec_for(full, leaf), mesh,
                                   _shape(leaf), path=full)
        if not any(sharded(s) for s in specs.values()):
            continue
        shard_leaves = getattr(layer, "shard_leaves", None)
        if shard_leaves is None:
            bad = sorted(f"{prefix}/{r}" if prefix else r
                         for r, s in specs.items() if sharded(s))
            raise NotImplementedError(
                f"the plan shards {bad}, and {type(layer).__name__} has no "
                "parallel form that computes on a slice of them")
        for rel, lay in shard_leaves(specs, mesh).items():
            layouts[f"{prefix}/{rel}" if prefix else rel] = lay
    model.shard_layout = layouts
    return model


def local_slice(leaf, layout: Layout, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full leaf under ``layout``."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    idx = shard_slice(t.shape[layout.dim], mesh.size(layout.axis),
                      mesh.index(layout.axis), layout.groups)
    return t.index_select(layout.dim, idx.to(t.device))


def local_tree(model, full_tree, mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """{path: this rank's part of each leaf of ``full_tree``} as the
    sharded ``model`` holds it: what its ``export_params`` would read if
    its weights were ``full_tree``'s (the way to hold a sharded model's
    weights against a one-rank run's)."""
    mesh = mesh or get_context().mesh
    lays = getattr(model, "shard_layout", {})
    return {p: (local_slice(l, lays[p], mesh) if p in lays else
                torch.as_tensor(np.asarray(l) if not isinstance(
                    l, torch.Tensor) else l))
            for p, l in leaf_paths(full_tree)}


def take_shard(module: nn.Module, attr: str, layout: Layout,
               mesh: Mesh) -> None:
    """Replace the parameter ``module.<attr>`` by this rank's slice under
    ``layout``, marked with the axis it is split over
    (``_zoo_shard_axes``: the Estimator's global gradient norm reads
    it)."""
    full = getattr(module, attr)
    with torch.no_grad():
        part = nn.Parameter(local_slice(full.detach(), layout,
                                        mesh).clone().contiguous(),
                            requires_grad=full.requires_grad)
    part._zoo_shard_axes = (layout.axis,)
    setattr(module, attr, part)


def replicated_plan() -> ShardingPlan:
    return ShardingPlan([], default=P())


def _quantized_companions(pat: str, column: bool
                          ) -> List[Tuple[str, PartitionSpec]]:
    """Sharding rules for a ``.../W$`` rule's quantized siblings: the
    int8/int4 weight leaves split like the float weight they replace;
    per-out-channel ``s_w`` (N,) splits with a column-parallel out dim and
    replicates for row-parallel; group-wise ``s_g`` (groups, N) keeps its
    group axis with the contraction dim."""
    if not pat.endswith("/W$"):
        return []
    wq = pat.replace("/W$", "/W_q$")
    wq4 = pat.replace("/W$", "/W_q4$")
    sw = pat.replace("/W$", "/s_w$")
    sg = pat.replace("/W$", "/s_g$")
    if column:       # (K, N) split on N
        return [(wq, P(None, "model")), (wq4, P(None, "model")),
                (sw, P("model",)), (sg, P(None, "model"))]
    return [(wq, P("model", None)), (wq4, P("model", None)),
            (sw, P()), (sg, P("model", None))]


def megatron_plan(column_patterns: Optional[Sequence[str]] = None,
                  row_patterns: Optional[Sequence[str]] = None,
                  embed_patterns: Optional[Sequence[str]] = None
                  ) -> ShardingPlan:
    """Default tensor-parallel plan for transformer-ish stacks: qkv/ffn-in
    column-parallel, attention-out/ffn-proj row-parallel, embeddings
    vocab-sharded, each weight rule with its quantized siblings' rules
    (the JAX package's regexes, leaf for leaf)."""
    rules: List[Tuple[str, PartitionSpec]] = []
    for pat in (column_patterns or [r".*qkv/W$", r".*_ffn/fc/W$",
                                    r".*fc\d*/W$"]):
        rules.append((pat, P(None, "model")))
        rules.extend(_quantized_companions(pat, column=True))
    for pat in (column_patterns or [r".*qkv/b$", r".*_ffn/fc/b$"]):
        rules.append((pat.replace("/W$", "/b$"), P("model",)))
    for pat in (row_patterns or [r".*attn/out/W$", r".*_ffn/proj/W$"]):
        rules.append((pat, P("model", None)))
        rules.extend(_quantized_companions(pat, column=False))
    for pat in (embed_patterns or [r".*(wte|word|embed.*)/(E)$", r".*wte$",
                                   r".*word$"]):
        rules.append((pat, P("model", None)))
    return rules and ShardingPlan(rules) or replicated_plan()


def data_parallel_batch(ctx, *arrays):
    """Each batch array's shard over the data axis (this rank's rows), on
    the context's device (a helper mirroring ``Estimator``'s feed)."""
    return [ctx.global_device_put(a, ctx.data_sharding(
        _ndim(a[0] if isinstance(a, (list, tuple)) else a)))
        for a in arrays]


def process_rows(n: int, batch_size: int, ctx=None) -> np.ndarray:
    """The rows of an n-row dataset this rank feeds in a multi-process
    fit with ``shuffle=False`` so that global batch k is rows
    [k·batch_size, (k+1)·batch_size) in order, as a one-process fit
    batches them: each batch's rows split over ``data`` in order."""
    ctx = ctx or get_context()
    d, dp = ctx.mesh.index(DATA_AXIS), ctx.data_parallel_size
    fb = batch_size // dp
    return np.concatenate([np.arange(s + d * fb, min(s + (d + 1) * fb, n))
                           for s in range(0, n, batch_size)])


# -- serving-side plan selection -------------------------------------------------

# Below this many parameters, tensor parallelism costs more in per-layer
# all-reduces than it buys in per-device FLOPs at serving batch sizes:
# small models replicate and shard the BATCH instead.
SERVING_TP_MIN_PARAMS = 50_000_000


def _param_count(params) -> int:
    return int(sum(int(np.prod(_shape(l))) for _, l in leaf_paths(params)))


def tensor_parallel_applicable(params) -> bool:
    """True when at least one leaf matches a ``megatron_plan`` rule."""
    plan = megatron_plan()
    return any(len(plan.spec_for(p, l)) > 0 for p, l in leaf_paths(params))


def serving_mode_for(params,
                     min_tensor_params: int = SERVING_TP_MIN_PARAMS) -> str:
    """The ``sharding=auto`` heuristic: "batch" for small models,
    "tensor" (megatron_plan) for large transformer-ish ones."""
    if _param_count(params) >= min_tensor_params \
            and tensor_parallel_applicable(params):
        return "tensor"
    return "batch"


def serving_mesh(n_devices: Optional[int] = None, mode: str = "batch",
                 devices: Optional[Sequence[int]] = None,
                 shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The 2-D serving mesh (axes ``data`` x ``model``) over ranks:
    ``mode="batch"`` lays them all on data, ``"tensor"`` on model; an
    explicit ``shape=(dd, mm)`` overrides both.  Every rank of the world
    builds it (it makes process groups)."""
    rank, world = _world()
    devs = list(devices if devices is not None else range(world))
    if shape is not None:
        dd, mm = int(shape[0]), int(shape[1])
    else:
        n = int(n_devices) if n_devices else len(devs)
        dd, mm = (1, n) if mode == "tensor" else (n, 1)
    need = dd * mm
    if need > len(devs):
        raise ValueError(
            f"serving mesh {dd}x{mm} needs {need} processes, have "
            f"{len(devs)} (start a torch.distributed world of {need})")
    return Mesh((DATA_AXIS, MODEL_AXIS), (dd, mm), devs[:need], rank)


def serving_plan(model_or_params, mesh: Mesh,
                 min_tensor_params: int = SERVING_TP_MIN_PARAMS
                 ) -> ShardingPlan:
    """The parameter plan for serving over ``mesh``: replicate small
    models, ``megatron_plan`` for large transformer blocks when the mesh
    has a ``model`` axis to put them on."""
    params = getattr(model_or_params, "_params", None)
    if params is None:
        params = model_or_params
    if mesh.size(MODEL_AXIS) > 1 \
            and _param_count(params) >= min_tensor_params \
            and tensor_parallel_applicable(params):
        return megatron_plan()
    return replicated_plan()


# -- the layers' parallel forms share these ---------------------------------------

def column_axis(spec) -> Optional[str]:
    """The axis of a column-parallel (K, N) spec P(None, axis), else None."""
    spec = tuple(spec)
    return spec[1] if len(spec) == 2 and spec[0] is None else None


def row_axis(spec) -> Optional[str]:
    """The axis a fitted spec splits dimension 0 over, others whole (row-
    parallel weights, vocab-sharded tables, stacked experts or stages),
    else None."""
    spec = tuple(spec)
    return spec[0] if len(spec) == 1 and spec[0] is not None else None


def check_specs(layer, specs: Dict, allowed: Dict) -> None:
    """Raise naming the leaves whose fitted spec ``layer``'s parallel form
    cannot compute on (``allowed``: relative path -> accepted specs)."""
    bad = sorted(f"{rel} {tuple(s)}" for rel, s in specs.items()
                 if tuple(s) not in allowed.get(rel, {()}))
    if bad:
        raise NotImplementedError(
            f"{layer.name}: no parallel form of {type(layer).__name__} "
            f"computes on these leaves' slices: {bad}")


def held_or_sliced(t: torch.Tensor, held: bool, layout: Layout,
                   mesh: Mesh) -> torch.Tensor:
    """This rank's part of a leaf a parallel form computes on: the leaf
    itself where the rank holds its slice, else the slice of the
    replicated leaf, taken through ``copy_to`` so that its gradient (each
    rank's part) is summed back into the whole."""
    if held:
        return t
    from analytics_zoo_tpu_torch.parallel import comm
    return local_slice(comm.copy_to(t, layout.axis, mesh), layout, mesh)


def vocab_parallel_rows(table: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, axis: str,
                        mesh: Mesh) -> torch.Tensor:
    """Rows of a table whose vocabulary (dim 0) is split over ``axis``, at
    wrapped ids: each rank looks up the ids in its range, zeros
    elsewhere, and the ranks' rows are summed; invalid ids give NaN rows
    (the lookup's rule)."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.parallel import comm
    v_l = table.shape[0]
    lo = mesh.index(axis) * v_l
    mine = (ids >= lo) & (ids < lo + v_l)
    rows = F.embedding(torch.where(mine, ids - lo, 0), table)
    rows = comm.psum(torch.where(mine[..., None], rows, 0.0), axis, mesh)
    return torch.where(valid[..., None], rows, float("nan"))
