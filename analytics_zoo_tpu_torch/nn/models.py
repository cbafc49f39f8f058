"""Containers: ``Sequential`` (the JAX package's ``nn/models.py:120``) and
the Keras-style training façade ``KerasNet`` (``nn/models.py:21``).

Layers are threaded in order; ``add`` builds each new layer for the
output shape of the one before it (the first layer must declare
``input_shape``, as in the JAX package).  The param tree is
``{layer_name: subtree}``.  ``compile`` / ``fit`` / ``evaluate`` /
``predict`` go through the ``Estimator``; a port model owns its
parameters, so ``fit`` trains them in place, and ``get_weights`` /
``set_weights`` read and write them as a JAX-layout tree.  The graph
``Model`` comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.nn.module import Layer


class KerasNet(Layer):
    """The compile/fit/evaluate/predict surface (Topology.scala:137-549).
    ``compile`` shadows ``nn.Module.compile`` with the Keras meaning."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._estimator: Optional[Estimator] = None

    def compile(self, optimizer, loss, metrics=None):
        """Configure training.  Optimizer/loss/metrics may be strings
        (Keras names) or objects."""
        self._estimator = Estimator(self, optimizer=optimizer, loss=loss,
                                    metrics=metrics or [])
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
        est = self._estimator or Estimator(self)
        return est.predict(x, batch_size=batch_size)

    def get_weights(self):
        """The parameters as a JAX-layout tree of detached tensors."""
        from analytics_zoo_tpu_torch.utils.convert import export_params
        return export_params(self)

    def set_weights(self, params, state=None):
        """Load a JAX-layout tree (numpy or tensor leaves) in place."""
        from analytics_zoo_tpu_torch.utils.convert import load_jax_params
        load_jax_params(self, params)


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

    def forward(self, x):
        for layer in self.layers_list:
            x = layer(x)
        return x
