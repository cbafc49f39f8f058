"""Zouwu — time-series forecasting toolkit; the JAX package's
``zouwu/forecast.py``.

Reference parity: pyzoo/zoo/zouwu — `LSTMForecaster` (model/forecast.py:49-107),
`MTNetForecaster` (:108-160), `AutoTSTrainer` (autots/forecast.py:22-79) and
`TSPipeline` (:81-170).  Forecasters are thin ``Sequential`` / ``Model``
builds; AutoTS wraps the automl ``TimeSequencePredictor``.

Each entry point takes ``device=`` under the port's device rule
(``common/context.resolve_device``).  A forecaster's ``Dense`` head is
what ``InferenceModel.do_quantize`` serves through the ``w8a8`` /
``w4a16`` kernels.  ``MTNetLayer`` is one layer holding its encoders: the
quantizer walks only ``Sequential`` / ``Model`` layer lists, so an int8
or int4 MTNet quantizes nothing and runs in float, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch
from torch import nn

from analytics_zoo_tpu_torch.automl.regression import (
    Recipe, TimeSequencePipeline, TimeSequencePredictor)
from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.conv import Convolution1D
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM
from analytics_zoo_tpu_torch.nn.models import Model, Sequential
from analytics_zoo_tpu_torch.nn.module import Layer, dropout, to_shape


class Forecaster(ZooModel):
    """Common fit/predict surface over (B, lookback, features) windows."""

    def fit(self, x, y, **kw):
        kw.setdefault("verbose", False)
        return self.model.fit(x, y, **kw)


class LSTMForecaster(Forecaster):
    """Two stacked LSTMs + dropout -> dense horizon head (forecast.py:49-107)."""

    def __init__(self, horizon: int = 1, feature_dim: int = 1,
                 lookback: int = 10, lstm_1_units: int = 16,
                 lstm_2_units: int = 8, dropout: float = 0.2,
                 target_col_num: int = 1, device: DeviceLike = None):
        self.horizon = horizon
        self.feature_dim = feature_dim
        self.lookback = lookback
        self.l1, self.l2 = lstm_1_units, lstm_2_units
        self.dropout = dropout
        super().__init__(device=device)

    def build_model(self) -> Sequential:
        m = Sequential(name="LSTMForecaster")
        m.add(LSTM(self.l1, return_sequences=True,
                   input_shape=(self.lookback, self.feature_dim),
                   name="zf_lstm1"))
        m.add(Dropout(self.dropout, name="zf_drop1"))
        m.add(LSTM(self.l2, return_sequences=False, name="zf_lstm2"))
        m.add(Dropout(self.dropout, name="zf_drop2"))
        m.add(Dense(self.horizon, name="zf_out"))
        return m


class Seq2SeqForecaster(Forecaster):
    """GRU encoder-decoder forecaster (automl/model Seq2Seq flavour)."""

    def __init__(self, horizon: int = 1, feature_dim: int = 1,
                 lookback: int = 10, latent_dim: int = 32,
                 dropout: float = 0.1, device: DeviceLike = None):
        self.horizon = horizon
        self.feature_dim = feature_dim
        self.lookback = lookback
        self.latent = latent_dim
        self.dropout = dropout
        super().__init__(device=device)

    def build_model(self) -> Sequential:
        m = Sequential(name="Seq2SeqForecaster")
        m.add(GRU(self.latent, return_sequences=True,
                  input_shape=(self.lookback, self.feature_dim), name="s2s_enc"))
        m.add(Dropout(self.dropout, name="s2s_drop"))
        m.add(GRU(self.latent, return_sequences=False, name="s2s_dec"))
        m.add(Dense(self.horizon, name="s2s_out"))
        return m


_ENCODERS = ("m", "c", "q")


class MTNetLayer(Layer):
    """Memory Time-series Network (MTNet, Chang et al. 2018) — the FULL
    architecture behind the reference's MTNetForecaster
    (zouwu/model/forecast.py:108-160 over zoo.automl.model.MTNet):

    Input (B, (long_num + 1) * time_step, D): the first long_num*time_step
    rows are the long-term memory blocks X_1..X_n; the last time_step rows
    are the short-term query series Q.

      * three block encoders (separate weights, shared across blocks):
        Conv1D(filters, kernel, same) -> relu -> dropout -> GRU(uni_size)
        last state: Enc_m (memory keys m_i), Enc_c (memory values c_i),
        Enc_in (query embedding u from Q);
      * memory attention: p = softmax(<m_i, u>); context o = sum_i p_i c_i;
      * nonlinear head: y_nl = [o ; u] W + b;
      * autoregressive highway on the target channel's last ar_size steps:
        y = y_nl + y_ar.

    The encoders are registered sub-layers (``conv_m``, ``gru_m``, ...),
    so ``.to()``, the optimizer and ``export_params`` see them; the param
    tree is the JAX one, ``{conv_m, gru_m, conv_c, gru_c, conv_q, gru_q,
    head: {W, b}, ar: {W, b}}``, without ``ar`` when ``ar_size`` is 0.
    The three dropout sites draw from the layer's seed split by encoder.
    """

    def __init__(self, horizon: int, time_step: int, long_num: int,
                 filters: int = 32, kernel: int = 3, uni_size: int = 32,
                 ar_size: int = 4, dropout: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.horizon = int(horizon)
        self.time_step = int(time_step)
        self.long_num = int(long_num)
        # ar_size=0 disables the autoregressive highway entirely
        self.ar_size = min(max(int(ar_size), 0), self.time_step)
        self.drop = float(dropout)
        self.uni = int(uni_size)
        nm = self.name
        for which in _ENCODERS:
            setattr(self, f"conv_{which}", Convolution1D(
                filters, kernel, activation="relu", border_mode="same",
                name=f"{nm}_conv_{which}"))
            setattr(self, f"gru_{which}", GRU(
                uni_size, return_sequences=False, name=f"{nm}_gru_{which}"))
        self._build_declared()

    def build(self, input_shape):
        shape = to_shape(input_shape)
        T, D = shape[-2] // (self.long_num + 1), shape[-1]
        for which in _ENCODERS:
            conv = getattr(self, f"conv_{which}")
            conv.ensure_built((T, D))
            getattr(self, f"gru_{which}").ensure_built((T, conv.nb_filter))
        self.head_W = nn.Parameter(torch.empty(2 * self.uni, self.horizon))
        self.head_b = nn.Parameter(torch.zeros(self.horizon))
        if self.ar_size > 0:
            self.ar_W = nn.Parameter(torch.empty(self.ar_size, self.horizon))
            self.ar_b = nn.Parameter(torch.zeros(self.horizon))

    def reset_parameters(self, gen):
        for which in _ENCODERS:
            getattr(self, f"conv_{which}").reset_parameters(gen)
            getattr(self, f"gru_{which}").reset_parameters(gen)
        self.head_W.copy_(0.05 * torch.randn(self.head_W.shape, generator=gen))
        self.head_b.zero_()
        if self.ar_size > 0:
            self.ar_W.copy_(0.05 * torch.randn(self.ar_W.shape,
                                               generator=gen))
            self.ar_b.zero_()

    def compute_output_shape(self, input_shape):
        return (self.horizon,)

    def _tree(self) -> Dict:
        tree = {}
        for which in _ENCODERS:
            tree[f"conv_{which}"] = getattr(self, f"conv_{which}")
            tree[f"gru_{which}"] = getattr(self, f"gru_{which}")
        tree["head"] = {"W": self.head_W, "b": self.head_b}
        if self.ar_size > 0:
            tree["ar"] = {"W": self.ar_W, "b": self.ar_b}
        return tree

    def _encode(self, site: int, x):
        which = _ENCODERS[site]
        h = getattr(self, f"conv_{which}")(x)
        seed = self.train_seed(site)
        if seed is not None and self.drop > 0:
            h = dropout(h, self.drop, seed)
        return getattr(self, f"gru_{which}")(h)

    def forward(self, x):
        B, _, D = x.shape
        n, T = self.long_num, self.time_step
        mem = x[:, :n * T].reshape(B * n, T, D)
        q = x[:, n * T:]
        m = self._encode(0, mem).reshape(B, n, self.uni)
        c = self._encode(1, mem).reshape(B, n, self.uni)
        u = self._encode(2, q)
        att = torch.softmax(torch.einsum("bnu,bu->bn", m, u), dim=-1)
        o = torch.einsum("bn,bnu->bu", att, c)
        y_nl = torch.cat([o, u], dim=-1) @ self.head_W + self.head_b
        if self.ar_size == 0:
            return y_nl
        ar_in = x[:, -self.ar_size:, 0]
        return y_nl + (ar_in @ self.ar_W + self.ar_b)


class MTNetForecaster(Forecaster):
    """MTNet forecaster (reference zouwu model/forecast.py:108-160).

    lookback must equal (long_num + 1) * time_step; when time_step is not
    given it is derived as lookback // (long_num + 1)."""

    def __init__(self, horizon: int = 1, feature_dim: int = 1,
                 lookback: int = 16, cnn_filters: int = 32,
                 cnn_kernel: int = 3, ar_window: int = 4,
                 dropout: float = 0.1, long_num: int = 3,
                 time_step: Optional[int] = None, uni_size: int = 32,
                 device: DeviceLike = None):
        self.horizon = horizon
        self.feature_dim = feature_dim
        self.long_num = int(long_num)
        self.time_step = (int(time_step) if time_step
                          else lookback // (self.long_num + 1))
        if (self.long_num + 1) * self.time_step != lookback:
            raise ValueError(
                f"lookback={lookback} must equal (long_num+1)*time_step "
                f"= {(self.long_num + 1) * self.time_step}")
        self.lookback = lookback
        self.filters = cnn_filters
        self.kernel = cnn_kernel
        self.ar_window = ar_window
        self.dropout = dropout
        self.uni_size = uni_size
        super().__init__(device=device)

    def build_model(self) -> Model:
        inp = Input(shape=(self.lookback, self.feature_dim), name="mt_input")
        out = MTNetLayer(self.horizon, self.time_step, self.long_num,
                         filters=self.filters, kernel=self.kernel,
                         uni_size=self.uni_size, ar_size=self.ar_window,
                         dropout=self.dropout, name="mt_net")(inp)
        return Model(input=inp, output=out, name="MTNetForecaster")


class AutoTSTrainer:
    """AutoML-driven forecaster selection (autots/forecast.py:22-79)."""

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 horizon: int = 1,
                 extra_features_col: Optional[Sequence[str]] = None,
                 recipe: Optional[Recipe] = None, distributed: bool = False,
                 device: DeviceLike = None):
        self._predictor = TimeSequencePredictor(
            dt_col=dt_col, target_col=target_col,
            extra_features_col=extra_features_col, future_seq_len=horizon,
            recipe=recipe, distributed=distributed, device=device)

    def fit(self, train_df: pd.DataFrame,
            validation_df: Optional[pd.DataFrame] = None) -> "TSPipeline":
        pipe = self._predictor.fit(train_df, validation_df)
        return TSPipeline(pipe)


class TSPipeline:
    """Deployable fitted pipeline (autots/forecast.py:81-170)."""

    def __init__(self, pipeline: TimeSequencePipeline):
        self._p = pipeline

    def predict(self, df: pd.DataFrame) -> np.ndarray:
        return self._p.predict(df)

    def evaluate(self, df: pd.DataFrame, metrics=("mse", "smape")):
        return self._p.evaluate(df, metrics)

    def save(self, path: str):
        self._p.save(path)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TSPipeline":
        return TSPipeline(TimeSequencePipeline.load(path, device=device))
