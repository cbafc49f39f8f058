#!/usr/bin/env python3
"""The JAX package's CPU run of ``chip_smoke.py`` phase 11's AutoTS
protocol: the reference its limit (``FORECAST_RATIO_MAX``) is taken from.

The same series (``chip_smoke.forecast_series(0)``: 10,320 half-hourly
points, nyc_taxi's length and cadence), split (``forecast_split``) and
recipe (``LSTMGridRandomRecipe(**FORECAST_RECIPE)``, its grid at
parallelism 2) as the phase, on the JAX package's ``AutoTSTrainer`` on
the CPU; prints each trial's config and validation MSE, then the
pipeline's test MSE and sMAPE beside the persistence and seasonal-naive
forecasts' and its MSE over the better one's.  ``--seed`` seeds the JAX
context (the Estimator's shuffle and dropout; the port draws its
weights with its own generator, so several seeds bound the spread).  A
run takes a few minutes of CPU::

    JAX_PLATFORMS=cpu python3 forecast_reference.py --seed 0
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the JAX context")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from analytics_zoo_tpu.automl import LSTMGridRandomRecipe
    from analytics_zoo_tpu.common import dtypes
    from analytics_zoo_tpu.common.context import get_context
    from analytics_zoo_tpu.zouwu import AutoTSTrainer

    dtypes.set_policy(None)
    get_context().set_seed(args.seed)
    df = cs.forecast_series(0)
    train, val, test = cs.forecast_split(df)
    t0 = time.time()
    run = cs.autots_run(AutoTSTrainer, LSTMGridRandomRecipe, train, val)
    for i, t in enumerate(run["trials"]):
        c = t["config"]
        print(f"trial {i}: lstm_1_units {c['lstm_1_units']}, lstm_units "
              f"{c['lstm_units']}, batch {c['batch_size']}: validation MSE "
              f"{t['mse']:.6f}", flush=True)
    pipe = run["pipeline"]
    metrics = pipe.evaluate(test, ("mse", "smape"))
    naive = cs.naive_forecasts(df, len(train) + len(val),
                               int(pipe._p.config["lookback"]))
    print(f"seed {args.seed}: test MSE {metrics['mse']:.1f}, sMAPE "
          f"{metrics['smape']:.4f}; persistence {naive['persistence']}; "
          f"seasonal-naive {naive['seasonal_naive']}; ratio "
          f"{cs.forecast_ratio(metrics, naive):.4f} "
          f"({time.time() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
