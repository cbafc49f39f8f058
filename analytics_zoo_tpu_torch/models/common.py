"""ZooModel base — the model-zoo contract (the JAX package's
``models/common.py``, ZooModel.scala:37-154): a subclass implements
``build_model()``, and gets compile / fit / evaluate / predict and the
weights surface by delegation to the inner ``Sequential`` / ``Model``.

A zoo model is an entry point, so it follows the port's device rule
(``common/context.resolve_device``): its model is moved to ``cuda:0``
unless the caller passes ``device="cpu"``, and with no CUDA and no device
given it raises.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.common.context import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.nn.models import KerasNet


class ZooModel:
    """Base for built-in zoo models; ``self.model`` is the inner
    container, on ``self.device``."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model: KerasNet = self.build_model().to(self.device)

    def build_model(self) -> KerasNet:
        raise NotImplementedError

    def compile(self, optimizer, loss, metrics=None):
        self.model.compile(optimizer, loss, metrics)
        return self

    def fit(self, *args, **kwargs):
        return self.model.fit(*args, **kwargs)

    def evaluate(self, *args, **kwargs):
        return self.model.evaluate(*args, **kwargs)

    def predict(self, *args, **kwargs):
        return self.model.predict(*args, **kwargs)

    def init_weights(self, seed: int = 0):
        return self.model.init_weights(seed)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, params, state=None):
        self.model.set_weights(params, state)

    def save_weights(self, path: str):
        self.model.save_weights(path)

    def load_weights(self, path: str):
        self.model.load_weights(path)
        return self

    def summary(self, **kw):
        return self.model.summary(**kw)
