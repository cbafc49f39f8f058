"""ZooTrigger algebra — composable training-loop triggers; a copy of the
JAX package's ``common/triggers.py`` (device-neutral Python).

Reference parity: common/ZooTrigger.scala:33-170 — `EveryEpoch`, `SeveralIteration`,
`MaxEpoch`, `MaxIteration`, `MaxScore`, `MinLoss`, and the `And`/`Or` combinators sharing
a zoo state table.  Triggers receive a TrainState snapshot and return bool; end-triggers
stop training, cache-triggers fire checkpoints/summaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainState:
    epoch: int = 0          # completed epochs
    iteration: int = 0      # completed iterations (global step)
    loss: float = float("inf")
    score: Optional[float] = None   # last validation score
    epoch_finished: bool = False    # true at epoch boundaries


class ZooTrigger:
    def __call__(self, state: TrainState) -> bool:
        raise NotImplementedError

    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)


class EveryEpoch(ZooTrigger):
    def __call__(self, state):
        return state.epoch_finished


class SeveralIteration(ZooTrigger):
    def __init__(self, interval: int):
        self.interval = int(interval)

    def __call__(self, state):
        return state.iteration > 0 and state.iteration % self.interval == 0


class MaxEpoch(ZooTrigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, state):
        return state.epoch >= self.max_epoch


class MaxIteration(ZooTrigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def __call__(self, state):
        return state.iteration >= self.max_iteration


class MaxScore(ZooTrigger):
    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def __call__(self, state):
        return state.score is not None and state.score > self.max_score


class MinLoss(ZooTrigger):
    def __init__(self, min_loss: float):
        self.min_loss = float(min_loss)

    def __call__(self, state):
        return state.loss < self.min_loss


class And(ZooTrigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class Or(ZooTrigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
