"""TimeSequencePredictor + TimeSequencePipeline + Recipes — the JAX
package's ``automl/regression.py``.

Reference parity: `TimeSequencePredictor.fit → TimeSequencePipeline`
(automl/regression/time_sequence_predictor.py:37-276, pipeline/time_sequence.py:1-221)
and the `Recipe` HP-space presets (config/recipe.py:1-518).  Each trial builds a
forecaster from a sampled config (LSTM, two-layer LSTM, Seq2seq or MTNet),
trains it on unrolled windows with the ``Estimator``, and scores validation
MSE; the best config, retrained, becomes the pipeline (save/load: json and
the JAX package's npz weights file, so a pipeline saved by either package
loads in the other).

The recipes are the JAX package's, line for line, so a recipe samples the
same configs in both packages.  A trial's initial weights come from a
seed computed from the config's contents exactly as the JAX package
computes it (``trial_seed``); the weights drawn from it are the port's
own (``Layer.init_weights``).  A trial touches no state shared across
threads — its model, estimator, dropout seeds and shuffle generator are
its own, and the dtype policy is only read — so a thread-pooled engine
gives the metrics of the sequential loop.

``device=`` follows the port's device rule.  ``distributed=True`` is a
no-op in one process, as in the JAX package; over a ``torch.distributed``
world of several processes it dispatches the trials round-robin over
them (``search.MultiProcessSearchEngine``), each process training its
trials in a process-local context.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from analytics_zoo_tpu_torch.automl.feature import (ALL_DT_FEATURES,
                                                    TimeSequenceFeatureTransformer)
from analytics_zoo_tpu_torch.automl.search import (
    BayesSearchEngine, Choice, GridRandomSearchEngine, GridSearch, LogUniform,
    RandInt, RandomSearchEngine, SampleFn, SearchEngine, Uniform)
from analytics_zoo_tpu_torch.common.context import (DeviceLike,
                                                    resolve_device)
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.recurrent import GRU, LSTM
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.nn.optimizers import Adam


# -- recipes (config/recipe.py parity) ----------------------------------------

class Recipe:
    n_trials = 5
    parallelism = 1

    def search_space(self, all_available_features: Sequence[str] = ()) -> Dict:
        raise NotImplementedError

    def engine(self) -> SearchEngine:
        return RandomSearchEngine(n_trials=self.n_trials, mode="min",
                                  parallelism=self.parallelism)


def _feature_subset(all_features):
    """selected_features sampler — random subset of >=3 features
    (recipe.py:184-193)."""
    feats = list(all_features)

    def pick(cfg, rng):
        if len(feats) <= 3:
            return list(feats)
        k = int(rng.integers(3, len(feats) + 1))
        return list(rng.choice(feats, size=k, replace=False))
    return SampleFn(pick)


class SmokeRecipe(Recipe):
    n_trials = 2

    def search_space(self, all_available_features=()):
        return {"model": "LSTM",
                "lstm_units": Choice([8]), "lr": Choice([0.01]),
                "lookback": Choice([8]), "dropout": Choice([0.0]),
                "epochs": Choice([6]), "batch_size": Choice([32])}


class MTNetSmokeRecipe(Recipe):
    """One-config MTNet smoke (recipe.py:83-108 MTNetSmokeRecipe parity)."""

    n_trials = 1

    def search_space(self, all_available_features=()):
        return {"model": "MTNet", "lr": Choice([0.005]),
                "batch_size": Choice([32]), "epochs": Choice([3]),
                "dropout": Choice([0.1]), "time_step": Choice([4]),
                "filter_size": Choice([8]), "long_num": Choice([3]),
                "ar_size": Choice([2]), "lookback": Choice([16])}


class RandomRecipe(Recipe):
    def __init__(self, n_trials: int = 5, lookback_range=(6, 16),
                 parallelism: int = 1):
        self.n_trials = n_trials
        self.lookback_range = lookback_range
        self.parallelism = parallelism

    def search_space(self, all_available_features=()):
        space = {"model": "LSTM",
                 "lstm_units": Choice([16, 32, 64]),
                 "lr": LogUniform(1e-3, 3e-2),
                 "lookback": RandInt(*self.lookback_range),
                 "dropout": Choice([0.0, 0.1, 0.2]),
                 "epochs": Choice([3, 5]),
                 "batch_size": Choice([32, 64])}
        if all_available_features:
            space["selected_features"] = _feature_subset(
                all_available_features)
        return space


class BayesRecipe(RandomRecipe):
    def engine(self):
        return BayesSearchEngine(n_trials=self.n_trials, mode="min")


class GridRandomRecipe(Recipe):
    """Grid + random search over LSTM and Seq2seq models
    (recipe.py:156-214 parity: grid dims expand exhaustively,
    num_rand_samples random draws per grid point, trials run concurrently)."""

    def __init__(self, num_rand_samples: int = 1, look_back=8,
                 epochs: int = 5, parallelism: int = 2):
        self.num_rand_samples = num_rand_samples
        self.look_back = look_back
        self.epochs = epochs
        self.parallelism = parallelism

    def _lookback_sampler(self):
        lb = self.look_back
        if isinstance(lb, (tuple, list)):
            return RandInt(int(lb[0]), int(lb[1]))
        return int(lb)

    def search_space(self, all_available_features=()):
        space = {
            "model": SampleFn(lambda cfg, rng:
                              str(rng.choice(["LSTM", "Seq2seq"]))),
            "lstm_units": GridSearch([16, 32]),
            "dropout": Uniform(0.2, 0.5),
            "latent_dim": GridSearch([32, 64]),
            "lr": Uniform(0.001, 0.01),
            "batch_size": SampleFn(lambda cfg, rng:
                                   int(rng.choice([32, 64]))),
            "epochs": self.epochs,
            "lookback": self._lookback_sampler(),
        }
        if all_available_features:
            space["selected_features"] = _feature_subset(
                all_available_features)
        return space

    def engine(self):
        return GridRandomSearchEngine(num_rand_samples=self.num_rand_samples,
                                      mode="min",
                                      parallelism=self.parallelism)


class LSTMGridRandomRecipe(GridRandomRecipe):
    """LSTM-only grid+random recipe (recipe.py:216-288)."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 look_back=8, lstm_1_units=(16, 32, 64, 128),
                 lstm_2_units=(16, 32, 64), batch_size=(32, 64),
                 parallelism: int = 2):
        super().__init__(num_rand_samples, look_back, epochs, parallelism)
        self.lstm_1_units = list(lstm_1_units)
        self.lstm_2_units = list(lstm_2_units)
        self.batch_size = list(batch_size)

    def search_space(self, all_available_features=()):
        space = {
            "model": "LSTM",
            "lstm_1_units": SampleFn(
                lambda cfg, rng: int(rng.choice(self.lstm_1_units))),
            "dropout_1": 0.2,
            "lstm_units": GridSearch(self.lstm_2_units),   # lstm_2 analog
            "dropout": Uniform(0.2, 0.5),
            "lr": Uniform(0.001, 0.01),
            "batch_size": GridSearch(self.batch_size),
            "epochs": self.epochs,
            "lookback": self._lookback_sampler(),
        }
        if all_available_features:
            space["selected_features"] = _feature_subset(
                all_available_features)
        return space


class MTNetGridRandomRecipe(GridRandomRecipe):
    """MTNet grid+random recipe (recipe.py:289-360) — past_seq_len is the
    DEPENDENT sample (long_num + 1) * time_step."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 time_step=(3, 4), filter_size=(2, 4), long_num=(3, 4),
                 ar_size=(2, 3), batch_size=(32, 64), parallelism: int = 2):
        super().__init__(num_rand_samples, 8, epochs, parallelism)
        self.time_step = list(time_step)
        self.filter_size = list(filter_size)
        self.long_num = list(long_num)
        self.ar_size = list(ar_size)
        self.batch_size = list(batch_size)

    def search_space(self, all_available_features=()):
        space = {
            "model": "MTNet",
            "lr": Uniform(0.001, 0.01),
            "batch_size": GridSearch(self.batch_size),
            "epochs": self.epochs,
            "dropout": Uniform(0.2, 0.5),
            "time_step": SampleFn(
                lambda cfg, rng: int(rng.choice(self.time_step))),
            "filter_size": SampleFn(
                lambda cfg, rng: int(rng.choice(self.filter_size))),
            "long_num": SampleFn(
                lambda cfg, rng: int(rng.choice(self.long_num))),
            "ar_size": SampleFn(
                lambda cfg, rng: int(rng.choice(self.ar_size))),
            # dependent param: lookback = (long_num + 1) * time_step
            "lookback": SampleFn(
                lambda cfg, rng: (cfg["long_num"] + 1) * cfg["time_step"]),
        }
        if all_available_features:
            space["selected_features"] = _feature_subset(
                all_available_features)
        return space


def _build_trial_model(cfg: Dict, input_shape):
    """Model factory by cfg['model'] (LSTM / Seq2seq / MTNet) — stable layer
    names so saved pipelines reload across processes (and packages).  The
    model is built on the CPU; callers move it."""
    kind = cfg.get("model", "LSTM")
    horizon = int(cfg.get("horizon", 1))
    if kind == "Seq2seq":
        m = Sequential(name="ts_s2s_model")
        m.add(GRU(int(cfg.get("latent_dim", 32)), return_sequences=True,
                  input_shape=input_shape, name="ts_s2s_enc"))
        if cfg.get("dropout", 0) > 0:
            m.add(Dropout(float(cfg["dropout"]), name="ts_s2s_drop"))
        m.add(GRU(int(cfg.get("latent_dim", 32)), return_sequences=False,
                  name="ts_s2s_dec"))
        m.add(Dense(horizon, name="ts_s2s_out"))
        return m
    if kind == "MTNet":
        from analytics_zoo_tpu_torch.zouwu.forecast import MTNetLayer
        m = Sequential(name="ts_mtnet_model")
        m.add(MTNetLayer(horizon, int(cfg["time_step"]),
                         int(cfg["long_num"]),
                         filters=int(cfg.get("filter_size", 32)),
                         ar_size=int(cfg.get("ar_size", 4)),
                         dropout=float(cfg.get("dropout", 0.1)),
                         input_shape=input_shape, name="ts_mtnet"))
        return m
    m = Sequential(name="ts_lstm_model")
    if "lstm_1_units" in cfg:   # two-layer LSTM (LSTMGridRandomRecipe)
        m.add(LSTM(int(cfg["lstm_1_units"]), return_sequences=True,
                   input_shape=input_shape, name="ts_lstm1"))
        if cfg.get("dropout_1", 0) > 0:
            m.add(Dropout(float(cfg["dropout_1"]), name="ts_dropout1"))
        m.add(LSTM(int(cfg["lstm_units"]), return_sequences=False,
                   name="ts_lstm"))
    else:
        m.add(LSTM(int(cfg["lstm_units"]), return_sequences=False,
                   input_shape=input_shape, name="ts_lstm"))
    if cfg.get("dropout", 0) > 0:
        m.add(Dropout(float(cfg["dropout"]), name="ts_dropout"))
    m.add(Dense(horizon, name="ts_out"))
    return m


def trial_seed(cfg: Dict) -> int:
    """A trial's init seed from the config's CONTENTS (the JAX package's
    ``crc32`` of the sorted ``repr``s): not from which thread, process or
    position in the run order ran it."""
    return zlib.crc32(json.dumps(
        {k: repr(v) for k, v in sorted(cfg.items())}).encode())


class TimeSequencePredictor:
    """Searches the recipe's space, one trial a sampled config, and
    returns the best config's pipeline.  ``distributed=True`` is a no-op
    in one process (the JAX package's, too); over several
    ``torch.distributed`` processes the trials split round-robin over
    them (``MultiProcessSearchEngine``), whose context must be
    process-local (``init_context(devices=[rank])``)."""

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 future_seq_len: int = 1, recipe: Optional[Recipe] = None,
                 distributed: bool = False, device: DeviceLike = None):
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra = extra_features_col
        self.horizon = int(future_seq_len)
        self.recipe = recipe or RandomRecipe()
        self.distributed = bool(distributed)
        self.device = resolve_device(device)

    _DEFAULT_DT = ("HOUR", "DAYOFWEEK", "WEEKEND")

    def _features_of(self, cfg: Dict):
        sel = cfg.get("selected_features")
        return tuple(sel) if sel else self._DEFAULT_DT

    def _train_one(self, cfg: Dict, input_df: pd.DataFrame):
        seed = trial_seed(cfg)
        ft = TimeSequenceFeatureTransformer(self.dt_col, self.target_col,
                                            self.extra)
        lookback = int(cfg["lookback"])
        x, y = ft.fit_transform(input_df, lookback=lookback,
                                horizon=self.horizon,
                                dt_features=self._features_of(cfg))
        cfg = dict(cfg, horizon=self.horizon)
        model = _build_trial_model(cfg, input_shape=x.shape[1:]).to(
            self.device)
        model.compile(optimizer=Adam(lr=float(cfg["lr"])), loss="mse")
        model.init_weights(seed)
        model.fit(x, y, batch_size=int(cfg["batch_size"]),
                  nb_epoch=int(cfg["epochs"]), verbose=False)
        return model, ft, cfg, x, y, lookback

    def fit(self, input_df: pd.DataFrame,
            validation_df: Optional[pd.DataFrame] = None,
            verbose: bool = False) -> "TimeSequencePipeline":
        probe = TimeSequenceFeatureTransformer(self.dt_col, self.target_col,
                                               self.extra)
        space = self.recipe.search_space(probe.get_feature_list())
        engine = self.recipe.engine()
        if self.distributed and torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            from analytics_zoo_tpu_torch.automl.search import \
                MultiProcessSearchEngine
            engine = MultiProcessSearchEngine(engine)

        def train_fn(cfg: Dict) -> float:
            model, ft, cfg, x, y, lookback = self._train_one(cfg, input_df)
            if validation_df is not None:
                vx, vy = ft.transform(validation_df, lookback=lookback,
                                      horizon=self.horizon,
                                      dt_features=self._features_of(cfg))
            else:
                cut = int(0.8 * len(x))
                vx, vy = x[cut:], y[cut:]
            res = model.evaluate(vx, vy, batch_size=int(cfg["batch_size"]))
            mse = res["loss"]
            if verbose:
                print(f"trial cfg={cfg} mse={mse:.5f}")
            return mse

        engine.run(train_fn, space)
        self._last_trials = engine.trials
        best = engine.get_best_trial()
        # retrain best on full data for the pipeline
        model, ft, cfg, _, _, _ = self._train_one(best.config, input_df)
        return TimeSequencePipeline(model, ft, cfg)


class TimeSequencePipeline:
    def __init__(self, model: Sequential,
                 feature_transformer: TimeSequenceFeatureTransformer,
                 config: Dict):
        self.model = model
        self.ft = feature_transformer
        self.config = config

    def _dt_features(self):
        sel = self.config.get("selected_features")
        return tuple(sel) if sel else ("HOUR", "DAYOFWEEK", "WEEKEND")

    def predict(self, df: pd.DataFrame) -> np.ndarray:
        x, _ = self.ft.transform(df, lookback=int(self.config["lookback"]),
                                 horizon=int(self.config["horizon"]),
                                 dt_features=self._dt_features())
        y = self.model.predict(x, batch_size=128)
        return self.ft.inverse_scale_target(y)

    def evaluate(self, df: pd.DataFrame, metrics=("mse",)) -> Dict[str, float]:
        lookback = int(self.config["lookback"])
        horizon = int(self.config["horizon"])
        x, y = self.ft.transform(df, lookback=lookback, horizon=horizon,
                                 dt_features=self._dt_features())
        pred = self.model.predict(x, batch_size=128)
        y_t = self.ft.inverse_scale_target(y)
        p_t = self.ft.inverse_scale_target(pred)
        out = {}
        for m in metrics:
            if m == "mse":
                out["mse"] = float(np.mean((y_t - p_t) ** 2))
            elif m == "rmse":
                out["rmse"] = float(np.sqrt(np.mean((y_t - p_t) ** 2)))
            elif m in ("mae",):
                out["mae"] = float(np.mean(np.abs(y_t - p_t)))
            elif m == "smape":
                out["smape"] = float(100 * np.mean(
                    2 * np.abs(p_t - y_t) / (np.abs(p_t) + np.abs(y_t) + 1e-9)))
        return out

    # -- persistence (pipeline/time_sequence.py save/load) --------------------
    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.model.save_weights(os.path.join(path, "weights.npz"))
        meta = {"config": {k: v for k, v in self.config.items()},
                "scaler_min": np.asarray(self.ft._min).tolist(),
                "scaler_max": np.asarray(self.ft._max).tolist(),
                "dt_col": self.ft.dt_col, "target_col": self.ft.target_col,
                "extra": self.ft.extra}
        with open(os.path.join(path, "pipeline.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TimeSequencePipeline":
        """The pipeline saved at ``path``, its model on ``device``."""
        with open(os.path.join(path, "pipeline.json")) as f:
            meta = json.load(f)
        cfg = meta["config"]
        ft = TimeSequenceFeatureTransformer(meta["dt_col"], meta["target_col"],
                                            meta["extra"])
        ft._min = np.asarray(meta["scaler_min"], np.float32)
        ft._max = np.asarray(meta["scaler_max"], np.float32)
        n_feat = len(ft._min)
        model = _build_trial_model(cfg, input_shape=(int(cfg["lookback"]),
                                                     n_feat))
        model = model.to(resolve_device(device))
        model.init_weights(0)
        model.load_weights(os.path.join(path, "weights.npz"))
        return TimeSequencePipeline(model, ft, cfg)
