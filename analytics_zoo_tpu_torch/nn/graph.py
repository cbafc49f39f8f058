"""Symbolic graph tracing for the graph ``Model`` — the JAX package's
``nn/graph.py``.

Calling a ``Layer`` on a ``SymTensor`` records a node; ``Model(input=...,
output=...)`` (``nn/models.py``) sorts the recorded graph topologically
and runs it node by node.  A shared layer (one ``Layer`` object called
twice) shares its parameters, as in Keras.  Output shapes come from each
layer's ``compute_output_shape`` (the JAX package infers them with
``jax.eval_shape``); a layer is built for its input shape at its first
call.  Arithmetic on ``SymTensor``s (``+ - * /``, negation, powers,
slicing the non-batch axes) records ``Lambda`` nodes, the JAX package's
autograd ``Variable`` sugar (``nn/autograd.py`` builds on it); each such
node is named after its operation with a counter (``add_0``), since the
graph ``Model`` refuses two layers of one name.
"""

from __future__ import annotations

import copy
import itertools
from typing import List, Optional, Sequence, Union

from analytics_zoo_tpu_torch.nn.module import _auto_name, to_shape

_node_ids = itertools.count()


class SymTensor:
    """A symbolic tensor: the output of a layer applied to other symbolic
    tensors (``layer`` None for a placeholder input)."""

    __slots__ = ("layer", "inputs", "shape", "dtype", "nid", "name")

    def __init__(self, layer, inputs: List["SymTensor"], shape, dtype,
                 name: Optional[str] = None):
        self.layer = layer
        self.inputs = inputs
        self.shape = to_shape(shape)  # excludes the batch axis
        self.dtype = dtype
        self.nid = next(_node_ids)
        self.name = name or (layer.name if layer else f"input_{self.nid}")

    def __repr__(self):
        return f"SymTensor({self.name}, shape={self.shape})"

    # -- operator sugar (autograd Variable parity) --------------------------
    def _binop(self, other, fn, opname):
        from analytics_zoo_tpu_torch.nn.layers.core import Lambda
        if isinstance(other, SymTensor):
            return Lambda(lambda xs: fn(xs[0], xs[1]),
                          name=_auto_name(opname))([self, other])
        return Lambda(lambda x, c=other: fn(x, c),
                      name=_auto_name(opname + "c"))(self)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b, "add")

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a, "radd")

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b, "sub")

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a, "rsub")

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b, "mul")

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a, "rmul")

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b, "div")

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a, "rdiv")

    def __neg__(self):
        from analytics_zoo_tpu_torch.nn.layers.core import Lambda
        return Lambda(lambda x: -x, name=_auto_name("neg"))(self)

    def __pow__(self, p):
        from analytics_zoo_tpu_torch.nn.layers.core import Lambda
        return Lambda(lambda x: x ** p, name=_auto_name("pow"))(self)

    def __getitem__(self, idx):
        """Slice the non-batch axes (autograd ``Variable.indexSelect`` /
        ``slice``)."""
        from analytics_zoo_tpu_torch.nn.layers.core import Lambda
        full = (slice(None),) + (idx if isinstance(idx, tuple) else (idx,))
        return Lambda(lambda x: x[full], name=_auto_name("slice"))(self)

    def __deepcopy__(self, memo):
        """Copy the node with its ancestors in topological order: the
        default recursion through ``inputs`` nests a few frames per node
        and overflows on a ResNet-deep graph (``copy.deepcopy(model)``)."""
        for node in topo_sort([self]):
            if id(node) in memo:
                continue
            clone = SymTensor.__new__(SymTensor)
            memo[id(node)] = clone
            clone.layer = copy.deepcopy(node.layer, memo)
            clone.inputs = [memo[id(t)] for t in node.inputs]
            clone.shape, clone.dtype = node.shape, node.dtype
            clone.nid, clone.name = node.nid, node.name
        return memo[id(self)]


def Input(shape, dtype="float32", name: Optional[str] = None) -> SymTensor:
    """Graph placeholder (Topology.scala ``Input`` node)."""
    return SymTensor(None, [], to_shape(shape), dtype, name=name)


def is_symbolic(x) -> bool:
    """A ``SymTensor``, or a non-empty list of them."""
    if isinstance(x, (list, tuple)):
        return bool(x) and all(isinstance(t, SymTensor) for t in x)
    return isinstance(x, SymTensor)


def trace_call(layer, x: Union[SymTensor, Sequence[SymTensor]]) -> SymTensor:
    """Record ``layer(x)`` as a graph node: build the layer for the input
    shape (once) and infer the output shape."""
    multi = isinstance(x, (list, tuple))
    inputs = list(x) if multi else [x]
    in_shape = [t.shape for t in inputs] if multi else inputs[0].shape
    layer.ensure_built(in_shape)
    out_shape = layer.compute_output_shape(in_shape)
    return SymTensor(layer, inputs, out_shape, inputs[0].dtype)


def topo_sort(outputs: Sequence[SymTensor]) -> List[SymTensor]:
    """Deterministic topological order of the subgraph feeding
    ``outputs``."""
    seen, order = set(), []

    def visit(node: SymTensor):
        if node.nid in seen:
            return
        seen.add(node.nid)
        for dep in node.inputs:
            visit(dep)
        order.append(node)

    for out in outputs:
        visit(out)
    return order
