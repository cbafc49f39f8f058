"""Brownout degradation ladder: a copy of the JAX package's
``serving/brownout.py``.

Between "healthy" and "shed everything" a serving fleet has a third
mode: **degrade gracefully**.  This module is a hysteresis ladder driven
by the windowed SLO burn rate (``SloTracker`` — fraction of the error
budget being consumed):

- **stage 1** — suppress streaming partials (long-poll progress
  updates): pure overhead when the fleet is burning budget; finals
  still flow.
- **stage 2** — clamp ``gen.max_tokens`` for batch / best-effort
  generation traffic: long decodes are the biggest per-request cost
  the engine can shrink without dropping anyone.
- **stage 3** — shed best-effort at admission (serving/admission.py
  consults ``stage`` before the bucket): the last rung before hard
  overload behavior.

Hysteresis is what makes the ladder safe to automate: a stage is
entered only after burn exceeds its threshold for ``dwell_s``
(transient spikes don't flap the fleet into degradation), and exited
only after burn falls below ``exit_ratio`` x the entry threshold AND
the stage has been held ``hold_s`` (recovered capacity doesn't bounce
straight back into overload).  Every transition is recorded as a
flight-recorder ``brownout`` event and kept in a bounded in-memory
history that ``snapshot()`` exposes — so ``health()["brownout"]`` and
incident bundles show WHEN the replica degraded and why.

Pure stdlib, fake-clock injectable, no engine import.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

# burn-rate entry thresholds per stage (stage i entered above enter[i-1]);
# burn 1.0 = consuming the error budget exactly as fast as allowed
DEFAULT_ENTER = (1.0, 2.0, 4.0)
DEFAULT_EXIT_RATIO = 0.5
DEFAULT_DWELL_S = 2.0     # burn must exceed the threshold this long to climb
DEFAULT_HOLD_S = 10.0     # minimum residence in a stage before descending
DEFAULT_BATCH_MAX_TOKENS = 32
HISTORY = 32


class BrownoutLadder:
    """One per replica, owned by the engine; ``observe()`` is called
    from the read loop with the current SLO burn rate."""

    def __init__(self, config: Optional[Dict] = None,
                 clock=time.monotonic,
                 recorder=None,
                 registry=None,
                 replica_id: Optional[str] = None):
        cfg = config if isinstance(config, dict) else {}
        self.enabled = bool(cfg.get("enabled", True))
        self._clock = clock
        self._recorder = recorder
        self._replica = replica_id
        enter = cfg.get("enter")
        if isinstance(enter, (list, tuple)) and len(enter) == 3:
            try:
                self.enter = tuple(sorted(float(x) for x in enter))
            except (TypeError, ValueError):
                self.enter = DEFAULT_ENTER
        else:
            self.enter = DEFAULT_ENTER
        self.exit_ratio = self._clamped(cfg.get("exit_ratio"),
                                        DEFAULT_EXIT_RATIO, 0.0, 1.0)
        self.dwell_s = self._clamped(cfg.get("dwell_s"),
                                     DEFAULT_DWELL_S, 0.0, 3600.0)
        self.hold_s = self._clamped(cfg.get("hold_s"),
                                    DEFAULT_HOLD_S, 0.0, 3600.0)
        self.batch_max_tokens = max(1, int(
            cfg.get("batch_max_tokens", DEFAULT_BATCH_MAX_TOKENS)))
        self.stage = 0
        self._entered_at = self._clock()
        self._above_since: Optional[float] = None  # burn > next threshold
        self._last_burn = 0.0
        self._transitions: deque = deque(maxlen=HISTORY)
        self._g_stage = None
        if registry is not None:
            self._g_stage = registry.gauge(
                "serving_brownout_stage",
                "Brownout degradation ladder stage (0 = healthy)")
            self._g_stage.set(0)

    @staticmethod
    def _clamped(v, default: float, lo: float, hi: float) -> float:
        try:
            return min(hi, max(lo, float(v)))
        except (TypeError, ValueError):
            return default

    # -- policy helpers the engine consults per record --------------------
    @property
    def suppress_partials(self) -> bool:
        return self.stage >= 1

    def clamp_max_tokens(self, priority: str) -> Optional[int]:
        """Stage >= 2 clamps generation length for non-interactive
        traffic; interactive keeps its requested budget."""
        if self.stage >= 2 and priority in ("batch", "best_effort"):
            return self.batch_max_tokens
        return None

    @property
    def shed_best_effort(self) -> bool:
        return self.stage >= 3

    # -- the ladder --------------------------------------------------------
    def observe(self, burn_rate, now: Optional[float] = None) -> int:
        """Feed one burn-rate sample; returns the (possibly new) stage.
        Climbs ONE rung per dwell window and descends one rung per hold
        window — degradation and recovery are both gradual."""
        if not self.enabled:
            return self.stage
        if now is None:
            now = self._clock()
        try:
            burn = max(0.0, float(burn_rate))
        except (TypeError, ValueError):
            burn = 0.0
        self._last_burn = burn
        # climb: burn above the NEXT stage's entry threshold for dwell_s
        if self.stage < len(self.enter) and burn >= self.enter[self.stage]:
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= self.dwell_s:
                self._transition(self.stage + 1, burn, now)
                self._above_since = now if (
                    self.stage < len(self.enter)
                    and burn >= self.enter[self.stage]) else None
        else:
            self._above_since = None
        # descend: burn below exit threshold AND the stage was held
        if self.stage > 0 \
                and burn <= self.exit_ratio * self.enter[self.stage - 1] \
                and now - self._entered_at >= self.hold_s:
            self._transition(self.stage - 1, burn, now)
        return self.stage

    def _transition(self, to: int, burn: float, now: float) -> None:
        frm, self.stage = self.stage, to
        self._entered_at = now
        entry = {"from": frm, "to": to, "burn": round(burn, 4),
                 "t": now}
        self._transitions.append(entry)
        if self._g_stage is not None:
            self._g_stage.set(to)
        if self._recorder is not None:
            self._recorder.record(
                "brownout", stage=to,
                action=("enter" if to > frm else "exit"),
                reason=f"burn={burn:.2f}", count=frm,
                replica=self._replica)

    def snapshot(self) -> Dict:
        """The ``health()["brownout"]`` block; the transition history is
        what incident bundles and the fleet view render."""
        now = self._clock()
        history: List[Dict] = [
            {"from": t["from"], "to": t["to"], "burn": t["burn"],
             "age_s": round(now - t["t"], 3)}
            for t in self._transitions]
        return {
            "enabled": self.enabled,
            "stage": self.stage,
            "burn": round(self._last_burn, 4),
            "in_stage_s": round(now - self._entered_at, 3),
            "enter": list(self.enter),
            "exit_ratio": self.exit_ratio,
            "dwell_s": self.dwell_s,
            "hold_s": self.hold_s,
            "transitions": history,
        }
