"""Pipeline parallelism — GPipe microbatch pipelining over the ``pipe``
mesh axis; the JAX package's ``parallel/pipeline.py``.

Homogeneous stages (transformer blocks): per-stage parameters are
STACKED on a leading axis placed ``P("pipe")``, so each rank holds its
stage's weights.  The schedule runs M + S − 1 ticks: stage 0 takes
microbatch t at tick t, every stage applies its function and hands the
activation to the next stage with ``comm.ppermute``, and the last stage's
outputs are broadcast to every stage (a masked ``psum``).  The schedule
differentiates end to end through the rotations, so the same program
trains.  Every rank runs every tick (stale inputs outside a stage's
window, as in JAX, so the ranks' graphs and collectives stay alike; the
bubble is (S − 1)/(M + S − 1)).

The input microbatches are replicated and enter the schedule through
``comm.copy_to``, so their gradient (stage 0's) reaches every rank.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from analytics_zoo_tpu_torch.common.context import PIPE_AXIS, Mesh
from analytics_zoo_tpu_torch.parallel import comm


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def stack_stage_params(params_list):
    """Stack per-stage param trees along a new leading axis (to place
    ``P("pipe")``)."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def _schedule(apply, x, mesh: Mesh, axis_name: str):
    """The GPipe ticks: ``apply(inp)`` is this rank's stage."""
    S, s = mesh.size(axis_name), mesh.index(axis_name)
    M = x.shape[0]
    x = comm.copy_to(x, axis_name, mesh)
    first = torch.tensor(s == 0, device=x.device)
    act = torch.zeros_like(x[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (clipped past the end); the others
        # take the activation received; both operands stay in the graph
        out = apply(torch.where(first, x[min(t, M - 1)], act))
        outs.append(out)
        if t < M + S - 2:
            act = comm.ppermute(out, axis_name, 1, mesh)
    # the last stage's output for microbatch m comes at tick m + S - 1
    results = torch.stack(outs[S - 1:])
    last = float(s == S - 1)
    return comm.psum(results * last, axis_name, mesh)


def _own_stage(stacked_params, S: int, s: int):
    """This rank's stage slice of stacked params: leaves (S, ...) give
    entry s, leaves (1, ...) (already this rank's slice) entry 0."""
    def pick(a):
        if a.shape[0] == S:
            return a[s]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"stacked stage params lead with {a.shape[0]}, "
                         f"the pipe axis has {S} stages")
    return _tree_map(pick, stacked_params)


def pipeline_apply(stage_fn: Callable, stacked_params, x_microbatches,
                   mesh: Mesh, axis_name: str = PIPE_AXIS):
    """Run x through S pipelined stages.

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``;
    ``stacked_params``: leaves (S, ...) or this rank's (1, ...) slice;
    ``x_microbatches``: (M, Bm, ...), the same on every rank.  Returns
    the (M, Bm, ...) outputs on every rank."""
    S, s = mesh.size(axis_name), mesh.index(axis_name)
    params = _own_stage(stacked_params, S, s)
    return _schedule(lambda inp: stage_fn(params, inp), x_microbatches,
                     mesh, axis_name)


def pipeline_apply_stages(stage_fns, stage_params_list, x_microbatches,
                          mesh: Mesh, axis_name: str = PIPE_AXIS):
    """Heterogeneous GPipe: stage i applies its OWN function to its OWN
    param tree (structures may differ across stages).

    As in JAX, each stage's tree ravels to a flat f32 vector, the vectors
    pad to one length and stack (S, L); every rank takes its row through
    ``copy_to`` and unflattens it back to its stage's leaves in their own
    dtypes.  So the gradients of every stage's params reach every rank
    (the owner's, summed over the axis), as the JAX transpose gives them.
    Activations crossing stage boundaries share one shape and dtype.

    ``stage_fns``: [fn_i(params_i, x) -> y, y.shape == x.shape];
    ``stage_params_list``: their trees, the same on every rank;
    ``x_microbatches``: (M, Bm, ...).  Returns (M, Bm, ...) outputs on
    every rank."""
    S = len(stage_fns)
    if mesh.size(axis_name) != S:
        raise ValueError(f"mesh {axis_name} axis is "
                         f"{mesh.size(axis_name)} but {S} stages were given")
    s = mesh.index(axis_name)
    leaves = [_leaves(p) for p in stage_params_list]
    flats = [torch.cat([t.reshape(-1).to(torch.float32) for t in ls])
             if ls else torch.zeros(0) for ls in leaves]
    L = max(int(f.numel()) for f in flats)
    stacked = torch.stack([torch.nn.functional.pad(f, (0, L - f.numel()))
                           for f in flats])
    row = comm.copy_to(stacked, axis_name, mesh)[s]
    mine, at = [], 0
    for t in leaves[s]:
        mine.append(row[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    it = iter(mine)
    params = _tree_map(lambda _: next(it), stage_params_list[s])
    fn = stage_fns[s]
    return _schedule(lambda inp: fn(params, inp), x_microbatches, mesh,
                     axis_name)


def to_microbatches(x, n_micro: int):
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} "
                         "microbatches")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def from_microbatches(y):
    return y.reshape((-1,) + tuple(y.shape[2:]))


def stage_tree(stacked: Dict[str, torch.Tensor], index: int):
    """Entry ``index`` of every leaf of a stacked tree."""
    return _tree_map(lambda a: a[index], stacked)
