"""The model zoo's public names, as the JAX package's
``models/__init__.py`` exports them."""

from analytics_zoo_tpu_torch.models.common import ZooModel  # noqa: F401
from analytics_zoo_tpu_torch.models.anomalydetection import \
    AnomalyDetector  # noqa: F401
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: F401
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier  # noqa: F401
from analytics_zoo_tpu_torch.models.textmatching import (  # noqa: F401
    KNRM, evaluate_map, evaluate_ndcg)
