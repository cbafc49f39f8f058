"""Containers: ``Sequential`` (the JAX package's ``nn/models.py:120``).

Layers are threaded in order; ``add`` builds each new layer for the
output shape of the one before it (the first layer must declare
``input_shape``, as in the JAX package).  The param tree is
``{layer_name: subtree}``.  The graph ``Model`` and the training façade
(compile / fit / evaluate) come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from analytics_zoo_tpu_torch.nn.module import Layer


class Sequential(Layer):
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

    def forward(self, x):
        for layer in self.layers_list:
            x = layer(x)
        return x
