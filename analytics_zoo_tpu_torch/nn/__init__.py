"""The layer IR's public names, as the JAX package's ``nn/__init__.py``
exports them."""

from analytics_zoo_tpu_torch.nn.module import Layer, initializer  # noqa: F401
from analytics_zoo_tpu_torch.nn.graph import Input, SymTensor  # noqa: F401
from analytics_zoo_tpu_torch.nn.models import Model, Sequential  # noqa: F401
