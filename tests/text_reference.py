#!/usr/bin/env python3
"""The JAX package's CPU runs of ``chip_smoke.py`` phase 10's training
protocols: the references its quality thresholds (``TEXT_ACC_MIN``,
``NER_F1_MIN``, ``KNRM_NDCG_MIN``, ``KNRM_MAP_MIN``) are taken from.

The same data (``chip_smoke.text_data``, ``ner_data``, ``knrm_pairs``,
``knrm_groups`` at ``--seed``), models (``TEXT_CLS`` with the cnn encoder,
``NER_GEO``, ``KNRM_GEO``), optimizers, batches and epochs as the phase,
on the JAX package's models and ``Estimator`` on the CPU.  Prints one
JSON line a protocol: the per-epoch losses and the held-out accuracy
(TextClassifier), token accuracy and entity-span F1 of the Viterbi paths
(NER), NDCG@3 and MAP (KNRM).  ``--init`` seeds the JAX weights (the
port's are drawn by its own generator, so several inits bound the
spread).  Not a test: run it from the repository root::

    JAX_PLATFORMS=cpu python3 tests/text_reference.py --init 0 \\
        [--only classifier|ner|knrm]

A run of all three takes a few minutes of CPU and under 3 GB.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", type=int, default=0,
                    help="seed of the JAX weights")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed (the data)")
    ap.add_argument("--only", choices=("classifier", "ner", "knrm"))
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from analytics_zoo_tpu.common import dtypes
    from analytics_zoo_tpu.common.context import get_context
    from analytics_zoo_tpu.estimator.estimator import Estimator
    from analytics_zoo_tpu.models.textclassification import TextClassifier
    from analytics_zoo_tpu.models.textmatching import (KNRM, evaluate_map,
                                                       evaluate_ndcg)
    from analytics_zoo_tpu.models.textmodels import NER
    from analytics_zoo_tpu.nn.optimizers import Adam

    dtypes.set_policy(None)
    get_context().set_seed(args.seed)
    key = jax.random.PRNGKey(args.init)

    def report(name, **kw):
        print(json.dumps({"protocol": name, "init": args.init, **kw}),
              flush=True)

    if args.only in (None, "classifier"):
        t0 = time.perf_counter()
        data = cs.text_data(args.seed)
        tc = TextClassifier(**cs.TEXT_CLS, encoder="cnn",
                            embedding_weights=data["embedding"])
        tc.init_weights(key)
        tc.compile(Adam(lr=cs.TEXT_LR), "sparse_categorical_crossentropy",
                   metrics=["accuracy"])
        losses = [tc.fit(data["x"], data["y"], batch_size=cs.TEXT_BATCH,
                         nb_epoch=1, verbose=False).history["loss"][-1]
                  for _ in range(cs.TEXT_EPOCHS)]
        ev = tc.evaluate(data["x_test"], data["y_test"],
                         batch_size=cs.TEXT_BATCH)
        report("classifier", losses=losses, accuracy=ev["accuracy"],
               seconds=time.perf_counter() - t0)

    if args.only in (None, "ner"):
        t0 = time.perf_counter()
        train = cs.ner_data(args.seed, cs.NER_TRAIN)
        test = cs.ner_data(args.seed, cs.NER_TEST, shift=1)
        ner = NER(**cs.NER_GEO)
        ner.model._params = ner.model.build(key, None)
        ner.model._state = {}
        losses = [ner.fit(train["x"], train["y"], batch_size=cs.NER_BATCH,
                          epochs=1, verbose=False).history["loss"][-1]
                  for _ in range(cs.NER_EPOCHS)]
        s = cs.ner_scores(np.asarray(ner.predict(
            test["x"], batch_size=cs.NER_BATCH)), test)
        report("ner", losses=losses, **s, seconds=time.perf_counter() - t0)

    if args.only in (None, "knrm"):
        t0 = time.perf_counter()
        q, d, y = cs.knrm_pairs(args.seed, cs.KNRM_TRAIN)
        groups = cs.knrm_groups(args.seed)
        kn = KNRM(**cs.KNRM_GEO)
        kn.init_weights(key)
        est = Estimator(kn.model, optimizer=Adam(lr=cs.KNRM_LR),
                        loss="binary_crossentropy")
        losses = est.fit([q, d], y, batch_size=cs.KNRM_BATCH,
                         epochs=cs.KNRM_EPOCHS,
                         verbose=False).history["loss"]
        kn.model._params = est.params
        report("knrm", losses=losses,
               ndcg=evaluate_ndcg(kn, groups, k=3,
                                  batch_size=cs.KNRM_CANDIDATES),
               map=evaluate_map(kn, groups, batch_size=cs.KNRM_CANDIDATES),
               seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
