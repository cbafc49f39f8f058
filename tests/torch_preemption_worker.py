"""Preemption worker for the PyTorch port (spawned by
``tests/test_torch_port_checkpoint.py``).

Trains a small seeded model on the CPU with checkpointing on, printing
one JSON line a step (``{"step", "loss"}``).  Every epoch is the same
single batch, so a fit resumed at any step sees the batches an
uninterrupted fit would.  On SIGTERM the Estimator snapshots and exits
128+15; a rerun with ``--resume`` continues from the snapshot's step.

Run: python tests/torch_preemption_worker.py <ckpt_dir> [--resume] [--slow]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

STEPS = 40


def run(ckpt_dir, resume=False, slow=False, emit=print):
    """The worker's fit; ``emit`` gets each line.  Returns the
    Estimator."""
    from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
    from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                         SeveralIteration)
    from analytics_zoo_tpu_torch.estimator.estimator import Estimator
    from analytics_zoo_tpu_torch.nn.layers.core import Dense
    from analytics_zoo_tpu_torch.nn.models import Sequential
    from analytics_zoo_tpu_torch.nn.optimizers import Adam

    torch.set_num_threads(1)
    g = np.random.default_rng(2)
    x = g.normal(size=(32, 6)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    model = Sequential([Dense(8, activation="tanh", input_shape=(6,),
                              name="d1"),
                        Dense(1, activation="sigmoid", name="d2")]
                       ).init_weights(5)
    est = Estimator(model, optimizer=Adam(lr=0.05),
                    loss="binary_crossentropy", registry=MetricsRegistry(),
                    ctx=ZooContext(ZooConf(seed=11, device="cpu")))
    est.set_checkpoint(ckpt_dir, trigger=SeveralIteration(4))

    def observe(step, loss):
        emit(json.dumps({"step": step, "loss": float(loss)}))
        if slow:
            time.sleep(0.05)   # give the parent's SIGTERM a window

    est._listeners.append(observe)
    emit(json.dumps({"phase": "start", "resume": resume}))
    est.fit(x, y, batch_size=32, epochs=10 * STEPS, verbose=False,
            shuffle=False, end_trigger=MaxIteration(STEPS), resume=resume)
    emit(json.dumps({"phase": "done", "final_step": est.global_step}))
    return est


if __name__ == "__main__":
    run(sys.argv[1], resume="--resume" in sys.argv,
        slow="--slow" in sys.argv, emit=lambda line: print(line, flush=True))
