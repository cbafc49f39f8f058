#!/usr/bin/env python3
"""How often a profiler trace of decode-graph replays loses kernel
records, with and without ``ops/_impl.card_launches``' settling waits,
on one NVIDIA GPU.

``card_launches`` counts the kernels the card ran inside a block from a
``torch.profiler`` trace; ``chip_smoke.py`` and the card tests hold those
counts to exact launch arithmetic (paged launches = decode steps x 12).
A trace that starts recording and runs its block at once can lose the
records of kernels launched in its first moments, so the block waits
``SETTLE_S`` after recording starts and again before it stops.  This
probe serves two waves of decode-graph replays (the card tests' 12-layer
``TransformerLM``, paged f32 lanes, every decode quantum a graph replay)
under ``card_launches``, alternating ``SETTLE_S`` = 0 and its value, and
counts per trace the paged launches against decode steps x 12 and 100
marker kernels (``bitwise_not``) launched first in the block.  Run from
the repository root::

    python3 trace_probe.py [--trials 20]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.serving import generate as tgen

sys.path.insert(0, str(pathlib.Path(__file__).parent / "tests"))
from test_torch_port_card import (GEN_CARD, _gen_model,  # noqa: E402
                                  _gen_reqs, _serve)

MARKS = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}")
    _impl.KERNEL_NAMES["mark"] = "bitwise_not"
    settle = _impl.SETTLE_S
    b = tgen.ContinuousBatcher(_gen_model(dev),
                               tgen.GenerationParams(**GEN_CARD))
    b.warm()
    waves = (_gen_reqs(1), _gen_reqs(2, tag="b"))
    mark = torch.zeros(16, dtype=torch.int32, device=dev)
    lossy = {0.0: 0, settle: 0}
    for trial in range(args.trials):
        for s in (0.0, settle):
            _impl.SETTLE_S = s
            steps0 = b.decode_steps
            with _impl.card_launches(("paged", "mark")) as card:
                for _ in range(MARKS):
                    mark.bitwise_not_()
                for w in waves:
                    _serve(b, [(f"{trial}/{s}/{rid}", p, n)
                               for rid, p, n in w])
            want = (b.decode_steps - steps0) * 12
            lost = card["paged"] != want or card["mark"] != MARKS
            lossy[s] += lost
            print(json.dumps({"trial": trial, "settle_s": s,
                              "paged": card["paged"], "want": want,
                              "marks": card["mark"], "lost": lost}))
    _impl.SETTLE_S = settle
    print(json.dumps({"traces_with_lost_records": {
        str(s): f"{n} of {args.trials}" for s, n in lossy.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
