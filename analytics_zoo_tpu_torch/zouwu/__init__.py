"""Zouwu, the time-series toolkit, as the JAX package's
``zouwu/__init__.py`` exports it."""

from analytics_zoo_tpu_torch.zouwu.forecast import (  # noqa: F401
    AutoTSTrainer, Forecaster, LSTMForecaster, MTNetForecaster, MTNetLayer,
    Seq2SeqForecaster, TSPipeline)

__all__ = ["AutoTSTrainer", "TSPipeline", "Forecaster", "LSTMForecaster",
           "Seq2SeqForecaster", "MTNetForecaster", "MTNetLayer"]
