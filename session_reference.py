#!/usr/bin/env python3
"""The JAX package's CPU run of ``chip_smoke.py`` phase 9's
SessionRecommender protocol: the reference its Recall@20 threshold
(``SESSION_RECALL_MIN``) is taken from.

The same data (``chip_smoke.session_data(0)``: sessions at RSC15's item
count in 64 item clusters), model (``SESSION``), optimizer (Adam at
``SESSION_LR``), batch (``SESSION_BATCH``) and epochs as the phase, on the
JAX package's ``SessionRecommender`` and ``Estimator`` on the CPU; prints
the popularity baseline and, after each epoch, the loss, Recall@20 and
MRR@20 on the held-out sessions.  ``--init`` seeds the JAX weights (the
port's are drawn by its own generator, so several inits bound the
spread); ``--zipf`` overrides the clusters' Zipf exponent.  A run takes
about a minute of CPU and ~3 GB of memory::

    JAX_PLATFORMS=cpu python3 session_reference.py --init 0
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", type=int, default=0,
                    help="seed of the JAX weights")
    ap.add_argument("--zipf", type=float, default=None,
                    help="the clusters' Zipf exponent (default: the "
                         "phase's SESSION_ZIPF)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import chip_smoke as cs
    from analytics_zoo_tpu.common import dtypes
    from analytics_zoo_tpu.common.context import get_context
    from analytics_zoo_tpu.estimator.estimator import Estimator
    from analytics_zoo_tpu.models.recommendation.session_recommender \
        import SessionRecommender
    from analytics_zoo_tpu.nn import optimizers

    dtypes.set_policy(None)
    get_context().set_seed(0)
    if args.zipf is not None:
        cs.SESSION_ZIPF = args.zipf
    data = cs.session_data(0)
    sr = SessionRecommender(**cs.SESSION)
    sr.model.init_weights(jax.random.PRNGKey(args.init))
    est = Estimator(sr.model, optimizer=optimizers.Adam(cs.SESSION_LR),
                    loss="sparse_categorical_crossentropy")
    base = cs.popularity_baseline(data)
    print(f"zipf {cs.SESSION_ZIPF}, init {args.init}; popularity: "
          f"Recall@{cs.SESSION_TOP} {base['recall']:.4f}, "
          f"MRR@{cs.SESSION_TOP} {base['mrr']:.4f}", flush=True)
    for epoch in range(cs.SESSION_EPOCHS):
        t0 = time.time()
        hist = est.fit(data["x_train"], data["y_train"][:, None],
                       batch_size=cs.SESSION_BATCH, epochs=1, verbose=False)
        t1 = time.time()
        m = cs.ranked(lambda x: np.asarray(
            est.predict(x, batch_size=cs.SESSION_BATCH)),
            data["x_test"], data["y_test"])
        print(f"epoch {epoch + 1}: loss {hist.history['loss'][-1]:.4f}, "
              f"Recall@{cs.SESSION_TOP} {m['recall']:.4f}, "
              f"MRR@{cs.SESSION_TOP} {m['mrr']:.4f} (fit {t1 - t0:.1f} s, "
              f"evaluation {time.time() - t1:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
