"""AnomalyDetector — an LSTM forecaster with distance-threshold anomaly
flagging, the JAX package's ``models/anomalydetection.py``.

Reference parity: models/anomalydetection/AnomalyDetector.scala:40-222 —
stacked LSTMs with dropout over unrolled windows, predicting the next
value; the anomalies are the ``anomaly_fraction`` largest squared
distances between the series and the prediction.  ``unroll`` and
``detect_anomalies`` are the JAX package's numpy, unchanged.

Quantized by ``InferenceModel.do_quantize``, the ``Dense(1)`` head runs
the ``w8a8`` (int8) or ``w4a16`` (int4) kernel on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.recurrent import LSTM
from analytics_zoo_tpu_torch.nn.models import Sequential


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 device: DeviceLike = None):
        self.feature_shape = tuple(feature_shape)  # (unroll_length, features)
        self.hidden_layers = tuple(hidden_layers)
        self.dropouts = tuple(dropouts)
        if len(self.hidden_layers) != len(self.dropouts):
            raise ValueError("one dropout a hidden layer: "
                             f"{self.hidden_layers} vs {self.dropouts}")
        super().__init__(device)

    def build_model(self) -> Sequential:
        m = Sequential(name="AnomalyDetector")
        n = len(self.hidden_layers)
        for i, (h, d) in enumerate(zip(self.hidden_layers, self.dropouts)):
            m.add(LSTM(h, return_sequences=(i < n - 1),
                       input_shape=self.feature_shape if i == 0 else None,
                       name=f"ad_lstm{i}"))
            m.add(Dropout(d, name=f"ad_drop{i}"))
        m.add(Dense(1, name="ad_out"))
        return m

    # -- helpers (AnomalyDetector.scala unroll / detectAnomalies) -------------
    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int, predict_step: int = 1):
        """Sliding windows: x[i] = data[i : i+L],
        y[i] = data[i+L+step-1, 0]."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = data.shape[0] - unroll_length - predict_step + 1
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length + predict_step - 1:
                 unroll_length + predict_step - 1 + n, 0:1]
        return x, y

    @staticmethod
    def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_fraction: float = 0.05):
        """Return (anomaly_indices, distances, threshold): the top
        ``anomaly_fraction`` squared distances are anomalies (Scala
        detectAnomalies semantics)."""
        yt = np.asarray(y_true).reshape(-1)
        yp = np.asarray(y_pred).reshape(-1)
        dist = (yt - yp) ** 2
        k = max(1, int(len(dist) * anomaly_fraction))
        threshold = np.sort(dist)[-k]
        idx = np.where(dist >= threshold)[0]
        return idx, dist, float(threshold)
