"""Time-series feature engineering — a copy of the JAX package's
``automl/feature.py`` (pandas and numpy only), so that both packages
give the same windows, scales and saved files for the same frame.

Reference parity: `TimeSequenceFeatureTransformer` (automl/feature/time_sequence.py:
1-573) — datetime features (hour / dayofweek / weekend...), rolling unroll into
(lookback, features) windows, min-max scaling with train-fit/transform split, and
post-processing (inverse scaling) for predictions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

# every datetime feature the transformer can generate — recipes sample
# "selected_features" subsets from this list (time_sequence.py:324-341
# get_feature_list parity)
ALL_DT_FEATURES = ("HOUR", "DAY", "MONTH", "DAYOFWEEK", "WEEKEND",
                   "MINUTE", "IS_BUSY_HOURS", "IS_AWAKE")


class TimeSequenceFeatureTransformer:
    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 drop_missing: bool = True):
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra = list(extra_features_col or [])
        self.drop_missing = drop_missing
        self._min = None
        self._max = None

    # -- datetime features ----------------------------------------------------
    def _gen_dt_features(self, dt: "pd.Series",
                         selected: Sequence[str]) -> pd.DataFrame:
        out = pd.DataFrame(index=dt.index)
        if "HOUR" in selected:
            out["HOUR"] = dt.dt.hour
        if "MINUTE" in selected:
            out["MINUTE"] = dt.dt.minute
        if "DAY" in selected:
            out["DAY"] = dt.dt.day
        if "MONTH" in selected:
            out["MONTH"] = dt.dt.month
        if "DAYOFWEEK" in selected or "WEEKDAY" in selected:
            out["DAYOFWEEK"] = dt.dt.dayofweek
        if "WEEKEND" in selected:
            out["WEEKEND"] = (dt.dt.dayofweek >= 5).astype(int)
        if "IS_BUSY_HOURS" in selected:
            out["IS_BUSY_HOURS"] = dt.dt.hour.isin([7, 8, 9, 17, 18, 19]).astype(int)
        if "IS_AWAKE" in selected:
            out["IS_AWAKE"] = dt.dt.hour.isin(range(6, 23)).astype(int)
        return out

    def get_feature_list(self, df: Optional[pd.DataFrame] = None) -> List[str]:
        """All features a recipe may select from (get_feature_list parity)."""
        return list(ALL_DT_FEATURES) + list(self.extra)

    # -- scaling --------------------------------------------------------------
    def _fit_scale(self, arr: np.ndarray):
        self._min = arr.min(axis=0)
        self._max = arr.max(axis=0)

    def _scale(self, arr: np.ndarray) -> np.ndarray:
        span = np.where(self._max - self._min < 1e-9, 1.0, self._max - self._min)
        return (arr - self._min) / span

    def inverse_scale_target(self, y: np.ndarray) -> np.ndarray:
        span = (self._max[0] - self._min[0]) or 1.0
        return y * span + self._min[0]

    # -- unroll ---------------------------------------------------------------
    def fit_transform(self, df: pd.DataFrame, lookback: int = 10,
                      horizon: int = 1,
                      dt_features: Sequence[str] = ("HOUR", "DAYOFWEEK",
                                                    "WEEKEND")
                      ) -> Tuple[np.ndarray, np.ndarray]:
        mat = self._matrix(df, dt_features)
        self._fit_scale(mat)
        return self._unroll(self._scale(mat), lookback, horizon)

    def transform(self, df: pd.DataFrame, lookback: int = 10, horizon: int = 1,
                  dt_features: Sequence[str] = ("HOUR", "DAYOFWEEK", "WEEKEND"),
                  with_label: bool = True):
        mat = self._matrix(df, dt_features)
        scaled = self._scale(mat)
        if with_label:
            return self._unroll(scaled, lookback, horizon)
        x, _ = self._unroll(scaled, lookback, 0)
        return x

    def _matrix(self, df: pd.DataFrame, dt_features) -> np.ndarray:
        # parse the datetime column ONCE per call (feature gen + validation
        # share it; pd.to_datetime is O(n))
        dt = (pd.to_datetime(df[self.dt_col])
              if self.dt_col in df.columns else None)
        self._check_input(df, dt)
        if self.drop_missing:
            keep = df[self.target_col].notna()
            df = df[keep]
            if dt is not None:
                dt = dt[keep]
        cols = [df[self.target_col].to_numpy(np.float32)[:, None]]
        # dt_features may mix datetime features and extra-column names (a
        # recipe's sampled "selected_features" subset).  Extra columns are
        # all included unless the selection names a subset of them.
        sel = set(dt_features or ())
        selected_extra = ([c for c in self.extra if c in sel]
                          if sel & set(self.extra) else list(self.extra))
        for c in selected_extra:
            cols.append(df[c].to_numpy(np.float32)[:, None])
        dt_only = [f for f in (dt_features or ()) if f not in self.extra]
        if dt is not None and dt_only:
            dtf = self._gen_dt_features(dt, dt_only)
            cols.append(dtf.to_numpy(np.float32))
        return np.concatenate(cols, axis=1)

    def _check_input(self, df: pd.DataFrame, dt=None) -> None:
        """Input validation (time_sequence.py:359-414 _check_input analog).
        `dt`: the already-parsed datetime series, when the caller has one."""
        if self.target_col not in df.columns:
            raise ValueError(f"missing target column '{self.target_col}'")
        missing = [c for c in self.extra if c not in df.columns]
        if missing:
            raise ValueError(f"missing feature columns {missing}")
        if dt is None and self.dt_col in df.columns:
            dt = pd.to_datetime(df[self.dt_col])
        if dt is not None and dt.is_monotonic_increasing is False:
            raise ValueError(f"'{self.dt_col}' must be ascending")

    # -- post-processing (time_sequence.py:214-278) ---------------------------
    def post_processing(self, input_df: pd.DataFrame, y_pred: np.ndarray,
                        lookback: int) -> pd.DataFrame:
        """Unscaled predictions as a frame aligned to the datetimes being
        predicted: row i predicts the step(s) after window i."""
        y = self.inverse_scale_target(np.asarray(y_pred))
        dt = pd.to_datetime(input_df[self.dt_col]).to_numpy()
        starts = dt[lookback:lookback + len(y)]
        out = {"datetime": starts}
        horizon = y.shape[1] if y.ndim > 1 else 1
        y2 = y.reshape(len(y), horizon)
        for h in range(horizon):
            key = self.target_col if horizon == 1 else f"{self.target_col}_{h}"
            out[key] = y2[:, h]
        return pd.DataFrame(out)

    def unscale_uncertainty(self, y_uncertainty: np.ndarray) -> np.ndarray:
        """Uncertainties scale by the span only (no shift) —
        time_sequence.py:208-213 parity."""
        span = (self._max[0] - self._min[0]) or 1.0
        return np.asarray(y_uncertainty) * span

    # -- persistence (time_sequence.py:279-323 save/restore) ------------------
    def save(self, file_path: str):
        import json
        state = {"dt_col": self.dt_col, "target_col": self.target_col,
                 "extra": self.extra, "drop_missing": self.drop_missing,
                 "min": None if self._min is None
                 else np.asarray(self._min).tolist(),
                 "max": None if self._max is None
                 else np.asarray(self._max).tolist()}
        with open(file_path, "w") as f:
            json.dump(state, f)

    @classmethod
    def restore(cls, file_path: str) -> "TimeSequenceFeatureTransformer":
        import json
        with open(file_path) as f:
            state = json.load(f)
        ft = cls(state["dt_col"], state["target_col"], state["extra"],
                 state["drop_missing"])
        if state["min"] is not None:
            ft._min = np.asarray(state["min"], np.float32)
            ft._max = np.asarray(state["max"], np.float32)
        return ft

    @staticmethod
    def _unroll(mat: np.ndarray, lookback: int, horizon: int):
        n = mat.shape[0] - lookback - horizon + 1
        if n <= 0:
            raise ValueError("series shorter than lookback+horizon")
        x = np.stack([mat[i:i + lookback] for i in range(n)])
        if horizon == 0:
            return x, None
        y = np.stack([mat[i + lookback:i + lookback + horizon, 0]
                      for i in range(n)])
        return x, y
