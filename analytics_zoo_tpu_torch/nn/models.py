"""Containers: ``Sequential`` (the JAX package's ``nn/models.py:120``),
the graph ``Model`` (``nn/models.py:179``) and the Keras-style training
façade ``KerasNet`` (``nn/models.py:21``).

``Sequential`` threads its layers in order; ``add`` builds each new layer
for the output shape of the one before it (the first layer must declare
``input_shape``, as in the JAX package).  ``Model`` runs a graph of layers
called on ``SymTensor``s (``nn/graph.py``) in topological order.  Both
key their param tree ``{layer_name: subtree}`` and their state tree
(BatchNorm's moving statistics, buffers updated in place in training
mode) the same way.  ``compile`` / ``fit`` / ``evaluate`` / ``predict`` go
through the ``Estimator``; a port model owns its parameters and state, so
``fit`` trains them in place, and ``get_weights`` / ``set_weights`` read
and write them as JAX-layout trees.  ``save_weights`` / ``load_weights``
write and read the JAX package's weights file (``{"params", "state"}``
as one .npz, ``utils/serialization.py``), and ``summary`` prints its
rows: name and type, output shape, parameter count.

``Model`` also carries a fusion plan, computed once at construction: each
(``Convolution2D``, ``BatchNormalization``) node pair in which the conv is
``fusable_with_bn()`` (1×1, stride 1, no bias, linear, channels last,
float weights) and its output's only consumer is a BN over the last
axis.  In training mode such a pair runs through ``ops/fused_bn`` — the
product and the BN's sums in one kernel — and the BN takes the sums; in
eval mode the BN reads its moving statistics and nothing is fused.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from torch import nn

# the module, not its class: ``nn/__init__`` exports ``Model``, and the
# estimator imports ``nn``'s submodules, so this import runs while the
# estimator module may still be loading
from analytics_zoo_tpu_torch.estimator import estimator as _estimator
from analytics_zoo_tpu_torch.nn.graph import SymTensor, topo_sort
from analytics_zoo_tpu_torch.nn.layers.conv import Convolution2D
from analytics_zoo_tpu_torch.nn.layers.core import BatchNormalization
from analytics_zoo_tpu_torch.nn.module import Layer


class KerasNet(Layer):
    """The compile/fit/evaluate/predict surface (Topology.scala:137-549).
    ``compile`` shadows ``nn.Module.compile`` with the Keras meaning."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._estimator: Optional[_estimator.Estimator] = None

    def compile(self, optimizer, loss, metrics=None):
        """Configure training.  Optimizer/loss/metrics may be strings
        (Keras names) or objects."""
        self._estimator = _estimator.Estimator(
            self, optimizer=optimizer, loss=loss, metrics=metrics or [])
        return self

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, distributed=True, **kwargs):
        if self._estimator is None:
            raise RuntimeError("call compile(...) before fit(...)")
        return self._estimator.fit(x, y, batch_size=batch_size,
                                   epochs=nb_epoch,
                                   validation_data=validation_data, **kwargs)

    def evaluate(self, x, y=None, batch_size=32):
        if self._estimator is None:
            raise RuntimeError("call compile(...) before evaluate(...)")
        return self._estimator.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=128, distributed=True):
        est = self._estimator or _estimator.Estimator(self)
        return est.predict(x, batch_size=batch_size)

    def get_weights(self):
        """The parameters as a JAX-layout tree of detached tensors."""
        from analytics_zoo_tpu_torch.utils.convert import export_params
        return export_params(self)

    def set_weights(self, params, state=None):
        """Load a JAX-layout param tree (numpy or tensor leaves) and,
        when given, a state tree, in place."""
        from analytics_zoo_tpu_torch.utils.convert import (load_jax_params,
                                                           load_jax_state)
        load_jax_params(self, params)
        if state is not None:
            load_jax_state(self, state)

    # -- persistence (Net.load / saveModel parity, via npz, pickle-free) ----
    def save_weights(self, path: str):
        """``{"params": ..., "state": ...}`` in the JAX layout
        (``utils/convert.export_params`` / ``export_state``) as one .npz
        (``utils/serialization.save_pytree``): the JAX package's file."""
        from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                           export_state)
        from analytics_zoo_tpu_torch.utils.serialization import save_pytree
        save_pytree(path, {"params": export_params(self),
                           "state": export_state(self)})

    def load_weights(self, path: str):
        """Load a weights file into this model's own tree, in place (a
        port model holds weights from construction, so there is no
        skeleton to build).  A leaf the file lacks raises ``KeyError``."""
        from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                           export_state)
        from analytics_zoo_tpu_torch.utils.serialization import load_pytree
        tree = load_pytree(path, like={"params": export_params(self),
                                       "state": export_state(self)})
        self.set_weights(tree["params"], tree["state"])
        return self

    # -- introspection (summary printer, Topology.scala:686-705) -------------
    def summary(self, input_shape=None, print_fn=print):
        input_shape = input_shape or self._declared_input_shape
        rows = self._summary_rows(input_shape)
        total = sum(r[2] for r in rows)
        width = 88
        print_fn("_" * width)
        print_fn(f"{'Layer (type)':<44}{'Output Shape':<26}{'Param #':<12}")
        print_fn("=" * width)
        for name, shape, count in rows:
            print_fn(f"{name:<44}{str(shape):<26}{count:<12}")
        print_fn("=" * width)
        print_fn(f"Total params: {total:,}")
        print_fn("_" * width)
        return total

    def _summary_rows(self, input_shape):
        raise NotImplementedError


def _plain_shape(shape):
    """An output shape as the JAX package prints it: a tuple of ints, or
    a list of them for several outputs."""
    if isinstance(shape, list):
        return [_plain_shape(s) for s in shape]
    return tuple(int(d) for d in shape)


def _leaf_count(layer: Layer) -> int:
    """Elements in the layer's JAX-layout param tree."""
    from analytics_zoo_tpu_torch.utils.convert import export_params
    from analytics_zoo_tpu_torch.utils.serialization import \
        _flatten_with_paths
    return sum(leaf.numel() for _, leaf in
               _flatten_with_paths(export_params(layer)))


def _summary_row(layer: Layer, out_shape):
    return (f"{layer.name} ({type(layer).__name__})", _plain_shape(out_shape),
            _leaf_count(layer))


class Sequential(KerasNet):
    """Linear stack of layers (Topology.scala:827-961)."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None, name=None):
        super().__init__(name=name)
        self.layers_list = nn.ModuleList()
        self._out_shape = None
        for layer in (layers or []):
            self.add(layer)

    def add(self, layer: Layer) -> "Sequential":
        if not len(self.layers_list):
            if layer._declared_input_shape is None:
                raise ValueError(f"first layer {layer.name} needs "
                                 "input_shape= (Sequential.add)")
            self._declared_input_shape = layer._declared_input_shape
            shape = self._declared_input_shape
        else:
            shape = self._out_shape
        if any(layer.name == other.name for other in self.layers_list):
            raise ValueError(f"duplicate layer name {layer.name!r}")
        layer.ensure_built(shape)
        self._out_shape = layer.compute_output_shape(shape)
        self.layers_list.append(layer)
        self.built = True
        return self

    def compute_output_shape(self, input_shape):
        return self._out_shape

    def reset_parameters(self, gen):
        for layer in self.layers_list:
            layer.reset_parameters(gen)

    def _tree(self) -> Dict:
        return {layer.name: layer for layer in self.layers_list}

    def _state_tree(self) -> Dict:
        return {layer.name: layer for layer in self.layers_list}

    def forward(self, x):
        for layer in self.layers_list:
            x = layer(x)
        return x

    def _summary_rows(self, input_shape):
        rows = []
        shape = input_shape
        for layer in self.layers_list:
            shape = layer.compute_output_shape(shape)
            rows.append(_summary_row(layer, shape))
        return rows


def _fusion_plan(nodes: List[SymTensor], outputs: List[SymTensor]
                 ) -> Tuple[Tuple[SymTensor, SymTensor], ...]:
    """(conv node, BN node) pairs the fused route computes: a fusable
    ``Convolution2D`` whose output feeds exactly one node, a
    ``BatchNormalization`` over the last axis, and is not a model
    output."""
    consumers: Dict[int, List[SymTensor]] = {n.nid: [] for n in nodes}
    for n in nodes:
        for t in n.inputs:
            consumers[t.nid].append(n)
    out_ids = {n.nid for n in outputs}
    plan = []
    for n in nodes:
        users = consumers[n.nid]
        if (isinstance(n.layer, Convolution2D) and n.layer.fusable_with_bn()
                and n.nid not in out_ids and len(users) == 1
                and isinstance(users[0].layer, BatchNormalization)
                and users[0].layer.axis in (-1, len(n.shape))):
            plan.append((n, users[0]))
    return tuple(plan)


class Model(KerasNet):
    """Graph model over symbolic tensors (Topology.scala:604-825):
    ``Model(input=Input(shape=...), output=sym)``.  Shared layers share
    their parameters.  ``fusion_plan`` lists the (conv, BN) node pairs
    that run fused in training (module docstring)."""

    def __init__(self, input, output, name=None):
        super().__init__(name=name)
        self.input_nodes: List[SymTensor] = (
            list(input) if isinstance(input, (list, tuple)) else [input])
        self.output_nodes: List[SymTensor] = (
            list(output) if isinstance(output, (list, tuple)) else [output])
        self.multi_output = isinstance(output, (list, tuple))
        self.nodes = topo_sort(self.output_nodes)
        layers, seen = [], set()
        for n in self.nodes:
            if n.layer is None:
                if n not in self.input_nodes:
                    raise ValueError(f"graph references Input node {n.name} "
                                     "not listed in `input=`")
            elif id(n.layer) not in seen:
                if any(n.layer.name == other.name for other in layers):
                    raise ValueError(f"duplicate layer name "
                                     f"{n.layer.name!r}")
                seen.add(id(n.layer))
                layers.append(n.layer)
        # unique layers in topological order (shared layers once)
        self.graph_layers = nn.ModuleList(layers)
        shapes = [n.shape for n in self.input_nodes]
        self._declared_input_shape = shapes if len(shapes) > 1 else shapes[0]
        self.built = True
        self.fusion_plan = _fusion_plan(self.nodes, self.output_nodes)

    def compute_output_shape(self, input_shape):
        shapes = [n.shape for n in self.output_nodes]
        return shapes if self.multi_output else shapes[0]

    def reset_parameters(self, gen):
        for layer in self.graph_layers:
            layer.reset_parameters(gen)

    def _tree(self) -> Dict:
        return {layer.name: layer for layer in self.graph_layers}

    def _state_tree(self) -> Dict:
        return {layer.name: layer for layer in self.graph_layers}

    def _summary_rows(self, input_shape=None):
        """One row a layer, its output shape at its first call."""
        first = {}
        for n in self.nodes:
            if n.layer is not None:
                first.setdefault(id(n.layer), n.shape)
        return [_summary_row(layer, first[id(layer)])
                for layer in self.graph_layers]

    def forward(self, *inputs):
        xs = list(inputs[0]) if len(inputs) == 1 \
            and isinstance(inputs[0], (list, tuple)) else list(inputs)
        if len(xs) != len(self.input_nodes):
            raise ValueError(f"model expects {len(self.input_nodes)} inputs, "
                             f"got {len(xs)}")
        env = {n.nid: x for n, x in zip(self.input_nodes, xs)}
        fused = {conv.nid: bn.nid for conv, bn in self.fusion_plan} \
            if self.training else {}
        stats = {}
        for node in self.nodes:
            if node.layer is None:
                continue
            ins = [env[t.nid] for t in node.inputs]
            if node.nid in fused:
                y, stats[fused[node.nid]] = node.layer.fused_bn_forward(
                    ins[0])
            elif node.nid in stats:
                y = node.layer(ins[0], stats=stats.pop(node.nid))
            else:
                y = node.layer(ins if len(ins) > 1 else ins[0])
            env[node.nid] = y
        outs = [env[n.nid] for n in self.output_nodes]
        return outs if self.multi_output else outs[0]
