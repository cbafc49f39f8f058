#!/usr/bin/env python3
"""Predict with each warmed bucket replayed as a CUDA graph, against the
port's route, on one NVIDIA GPU.

``InferenceModel.warm`` runs a bucket's padded forward once, so the
bucket's first-call setup is done before traffic, and serving runs the
forward eagerly.  This probe measures what a CUDA graph of each warmed
bucket would change.  ``GraphInferenceModel`` captures the padded forward
at ``warm`` (``inference/aot.capture``) and replays it for every batch of
that signature.  A replay's output is copied, on the stream, into a
tensor of the caller's own before the replay lock is released, so the
next replay cannot overwrite a result still in flight.

Both routes serve ``chip_smoke.py``'s predict path: GPT-2-small
``TransformerLayer`` at T = 1024, mean pool, ``Dense(50257)``, f32, 32
records, batch 8.  They go through ``ClusterServing`` with the same
warm-up spec and the same protocol as ``chip_smoke.serve_predict``: the
records are sent once the warm-up is ready, under a profiler trace of
the card.  The routes alternate (eager, graph, eager, graph, ...).  Each
run prints records/s, e2e p50, forwards, replays, and the flash launches
on the card and by the wrapper; the graph route's top-5 must equal the
eager route's.  Then one 8 x 1024 batch of each route runs under
``torch.profiler`` (wall and kernel time).  Run from the repository
root::

    python3 predict_graph_probe.py [--seed 0] [--repeats 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

import chip_smoke as cs
from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving.engine import ServingParams


class GraphInferenceModel(InferenceModel):
    """An ``InferenceModel`` whose warmed buckets (f32 records, no
    per-row scales) replay a CUDA graph of the padded forward."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._programs = {}
        # a replay's fill, launch and output copy must not interleave with
        # another thread's
        self._replay_lock = threading.Lock()

    def warm(self, bucket: int, shape, dtype: str = "<f4",
             scales: bool = False) -> bool:
        if scales or np.dtype(dtype) != np.float32:
            raise ValueError("the probe captures f32 records only")
        fresh = super().warm(bucket, shape, dtype, scales)
        x = np.zeros((int(bucket),) + tuple(int(s) for s in shape),
                     np.float32)
        key = self._signature([x], None, False)
        if key not in self._programs:
            self._programs[key] = aot.capture(
                lambda x_: self._forward([x_], None, False),
                (self._to_device(x),), self.device)
        return fresh

    def _padded_call(self, xs, sc, multi):
        prog = self._programs.get(self._signature(xs, sc, multi))
        if prog is None:
            return super()._padded_call(xs, sc, multi)
        self._count_call(xs, sc, multi)
        host = torch.from_numpy(np.ascontiguousarray(xs[0])).pin_memory()
        with self._replay_lock, torch.inference_mode():
            prog.inputs[0].copy_(host, non_blocking=True)
            return prog.replay().clone()

    def replays(self) -> int:
        return sum(p.replays for p in self._programs.values())


ROUTES = {"eager": InferenceModel, "graph": GraphInferenceModel}


def top5(run) -> dict:
    return {rid: run["results"][rid]["value"] for rid in run["rids"]}


def same_top5(got: dict, ref: dict) -> float:
    """The largest log-probability gap over records whose top-5 classes
    match ``ref``'s; fails on a record whose classes differ."""
    worst = 0.0
    for rid, top in got.items():
        cs.check([int(c) for c, _ in top] == [int(c) for c, _ in ref[rid]],
                 f"probe: {rid} top-5 classes differ between the routes")
        lp = np.log(np.asarray([p for _, p in top], np.float64))
        lr = np.log(np.asarray([p for _, p in ref[rid]], np.float64))
        worst = max(worst, float(np.abs(lp - lr).max()))
    cs.check(worst <= cs.LOGP_TOL, f"probe: top-5 log-probabilities "
                                   f"differ by {worst:.3e}")
    return worst


def serve(route: str, model, X, tag: str, ref) -> dict:
    im = ROUTES[route](device=next(model.parameters()).device)
    im.do_load_model(model)
    run = cs.serve_predict(im, X, ServingParams(
        batch_size=cs.PREDICT_BATCH, max_wait_ms=2.0,
        warmup=cs.PREDICT_WARMUP))
    cs.check(run["dead_lettered"] == 0 and len(run["results"]) == len(X),
             f"probe[{tag}]: {len(run['results'])}/{len(X)} answered")
    fw = run["forwards"]
    replays = im.replays() if route == "graph" else 0
    flash = fw * cs.PREDICT["n_block"]
    cs.check(fw > 0 and run["warm_hits"] == fw, f"probe[{tag}]: {run}")
    cs.check(run["card"]["flash_fwd"] == flash
             and run["wrapper"]["flash_fwd"] == (0 if replays else flash)
             and replays in (0, fw),
             f"probe[{tag}]: flash launches on the card "
             f"{run['card']['flash_fwd']}, by the wrapper "
             f"{run['wrapper']['flash_fwd']}, {replays} replays in {fw} "
             f"forwards")
    err = same_top5(top5(run), ref) if ref is not None else 0.0
    n = len(X)
    out = {"route": route, "records_per_s": n / run["wall_s"],
           "e2e_p50_ms": run["e2e_p50_s"] * 1e3, "forwards": fw,
           "replays": replays, "card_flash": run["card"]["flash_fwd"],
           "wrapper_flash": run["wrapper"]["flash_fwd"],
           "warmup_s": run["warm"]["seconds"],
           "captures": run["warm"]["compile_stats"]["captures"]}
    cs.say(f"probe[{tag}]: warm-up {run['warm']['total']} buckets in "
           f"{out['warmup_s']:.3f} s ({out['captures']} graph captures); "
           f"{n} records in {run['wall_s']:.3f} s = "
           f"{out['records_per_s']:.2f} records/s, e2e p50 "
           f"{out['e2e_p50_ms']:.1f} ms (under the trace); {fw} forwards, "
           f"{replays} replays; flash launches on the card "
           f"{out['card_flash']}, by the wrapper {out['wrapper_flash']}; "
           f"top-5 log-prob gap to the first eager run {err:.3e}")
    del im
    return dict(out, top5=top5(run))


def profile_batch(route: str, model, X) -> dict:
    """One batch of a warmed bucket under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    im = ROUTES[route](device=next(model.parameters()).device)
    im.do_load_model(model)
    im.warm(len(X), X.shape[1:])
    im.do_predict(X)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.do_predict(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, busy = cs.kernel_rows(prof)
    cs.say(f"profile[{route}]: one batch of {len(X)} x {X.shape[1]} tokens "
           f"in {wall * 1e3:.2f} ms under the profiler, kernels "
           f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of the wall)")
    return {"wall_ms": wall * 1e3, "kernel_ms": busy * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("predict_graph_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.say(f"card: {cs.card_line()}")
    _build.build_all((fa.KERNEL,))
    model = cs.build_predict_model(args.seed).to(dev)
    X = cs.predict_records(args.seed)
    InferenceModel(device=dev).do_load_model(model).do_predict(
        X[:cs.PREDICT_BATCH])                      # CUDA warm-up
    torch.cuda.synchronize()
    runs, ref = [], None
    for i in range(args.repeats):
        for route in ROUTES:
            r = serve(route, model, X, f"{route} {i + 1}", ref)
            ref = ref or r["top5"]
            runs.append({k: v for k, v in r.items() if k != "top5"})
    prof = {route: profile_batch(route, model, X[:cs.PREDICT_BATCH])
            for route in ROUTES}
    cs.say(json.dumps({"predict_graph_probe": {"runs": runs,
                                                "profile": prof}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
