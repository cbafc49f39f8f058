#!/usr/bin/env python3
"""The zoo's host-bound trainings, eager and as k-step CUDA graphs.

Trains ``chip_smoke.py``'s NeuralCF (phase 8), AnomalyDetector (phase 9)
and NER (phase 10) twice each in one process on the card, with
``chip_smoke.ZOO_STEPS_PER_CALL`` at 1 (eager steps) and at 8 (the
Estimator's k-step route: every group after the first one CUDA graph of
8 whole steps), through the phases' own functions, which print each
run's losses, quality and ms/step on the host clock.  The two routes'
losses and qualities should agree; the ms/step show what the graph
route saves where Python dispatch bounds the step.  Run on a machine
with the card, from the repository root::

    python3 zoo_graph_probe.py
"""

import sys
import time

import torch

import chip_smoke as c


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_graph_probe: no CUDA device", file=sys.stderr)
        return 1
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    c.say(f"card: {c.card_line()}")
    data = c.ncf_data(0)
    for k in (1, 8):
        c.ZOO_STEPS_PER_CALL = k
        t0 = time.perf_counter()
        ncf = NeuralCF(data["n_users"], data["n_items"], 2, **c.NCF,
                       device=dev)
        ncf.init_weights(0)
        epochs = c.ncf_train(ncf, data, 0)
        c.check_ncf_train(epochs)
        c.say(f"probe[ncf k={k}]: {time.perf_counter() - t0:.2f} s")
        del ncf, epochs
    for k in (1, 8):
        c.ZOO_STEPS_PER_CALL = k
        t0 = time.perf_counter()
        c.anomaly_phase(0, dev)
        c.say(f"probe[anomaly k={k}]: {time.perf_counter() - t0:.2f} s")
    for k in (1, 8):
        c.ZOO_STEPS_PER_CALL = k
        t0 = time.perf_counter()
        out = c.ner_phase(0, dev)
        c.say(f"probe[ner k={k}]: {time.perf_counter() - t0:.2f} s "
              f"{out['losses']} f1 {out['f1']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
