"""Rollout policy: canary judging + rollout state, as PURE logic.

The supervisor (`manager.py:_run_supervisor`) owns the processes; this
module owns the decisions, so the judge and the state machine are unit
testable without forking a fleet:

- :class:`RolloutParams` — the ``rollout:`` config block (dwell window,
  burn-rate divergence knobs, error-rate ceiling, auto-rollback switch).
- :func:`judge` — one canary-vs-incumbents comparison over the
  per-replica health docs the supervisor already reads each pass.
  Returns ``None`` (healthy so far) or a human-readable divergence
  reason (→ auto-rollback).
- :func:`load_state` / :func:`save_state` — the supervisor's rollout
  state file (``<pidfile>.rollout.state.json``): phase, target/prior
  versions and the PER-REPLICA version assignments.  The assignments are
  the respawn pin: a replica that crashes mid-rollout respawns at its
  ASSIGNED version (incumbent or canary), never blindly at ``latest``.

Divergence policy: the canary is a fresh process, so its counters start
at zero and cumulative == since-canary-start.  It diverges when either

- its error fraction ``dead_lettered / (served + dead_lettered)`` exceeds
  ``error_rate_max`` (after ``min_records`` records, so one early
  quarantine can't condemn a version), or
- its windowed SLO burn rate exceeds ``max(burn_min,
  burn_factor * worst incumbent burn)`` — worse than the fleet AND bad in
  absolute terms, so a globally-degraded fleet doesn't scapegoat the
  canary.

Crash counting stays supervisor-side (it owns the wait() status); it
feeds :func:`judge` through ``canary_crashes``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

PHASES = ("idle", "canary", "rolling", "rollback")


class RolloutParams:
    """Parsed ``rollout:`` config block (all knobs optional)."""

    def __init__(self, canary_dwell_s: float = 30.0,
                 ready_timeout_s: float = 120.0,
                 burn_factor: float = 2.0,
                 burn_min: float = 1.0,
                 error_rate_max: float = 0.1,
                 min_records: int = 8,
                 crash_limit: int = 2,
                 auto_rollback: bool = True,
                 prewarm: bool = True):
        self.canary_dwell_s = float(canary_dwell_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.burn_factor = float(burn_factor)
        self.burn_min = float(burn_min)
        self.error_rate_max = float(error_rate_max)
        self.min_records = int(min_records)
        self.crash_limit = int(crash_limit)
        self.auto_rollback = bool(auto_rollback)
        self.prewarm = bool(prewarm)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RolloutParams":
        d = d if isinstance(d, dict) else {}
        kw = {}
        for key in ("canary_dwell_s", "ready_timeout_s", "burn_factor",
                    "burn_min", "error_rate_max", "min_records",
                    "crash_limit", "auto_rollback", "prewarm"):
            if key in d and d[key] is not None:
                kw[key] = d[key]
        return cls(**kw)


def _error_fraction(doc: dict) -> tuple:
    """(errors, seen, fraction) from one health doc."""
    errors = int(doc.get("dead_lettered") or 0)
    served = int(doc.get("total_records") or 0)
    seen = errors + served
    return errors, seen, (errors / seen if seen else 0.0)


def _burn(doc: dict) -> float:
    slo = doc.get("slo") or {}
    try:
        return float(slo.get("burn_rate") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def judge(canary: Optional[dict], incumbents: List[dict],
          params: RolloutParams, canary_crashes: int = 0) -> Optional[str]:
    """One judging pass.  ``canary`` is the canary replica's health doc
    (None when its snapshot is not readable yet — not a verdict),
    ``incumbents`` the remaining old-version replicas'.  Returns a
    divergence reason string, or None."""
    if canary_crashes > params.crash_limit:
        return (f"canary crashed {canary_crashes}x "
                f"(limit {params.crash_limit})")
    if canary is None:
        return None
    errors, seen, frac = _error_fraction(canary)
    if seen >= params.min_records and frac > params.error_rate_max:
        return (f"canary error rate {frac:.2f} "
                f"({errors}/{seen} records) > {params.error_rate_max:g}")
    cburn = _burn(canary)
    iburn = max([_burn(d) for d in incumbents], default=0.0)
    if cburn > max(params.burn_min, params.burn_factor * iburn):
        return (f"canary SLO burn {cburn:.2f} > "
                f"max({params.burn_min:g}, "
                f"{params.burn_factor:g} x incumbent {iburn:.2f})")
    return None


# -- rollout state file ------------------------------------------------------

def idle_state() -> dict:
    return {"phase": "idle", "target": None, "prior": None,
            "canary_index": None, "assignments": {}, "history": []}


def state_path(pidfile: str) -> str:
    return pidfile + ".rollout.state.json"


def request_path(pidfile: str) -> str:
    """`manager rollout <version>` writes the REQUEST here; the
    supervisor polls it (file-not-signal, same rationale as the scale
    file: survives a supervisor restart, inspectable)."""
    return pidfile + ".rollout.json"


def load_state(pidfile: str) -> dict:
    try:
        with open(state_path(pidfile)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return idle_state()
    base = idle_state()
    base.update(doc if isinstance(doc, dict) else {})
    # json keys are strings; assignments are index -> version
    base["assignments"] = {int(k): v for k, v in
                           (base.get("assignments") or {}).items()}
    return base


def save_state(pidfile: str, state: dict) -> None:
    path = state_path(pidfile)
    tmp = path + ".tmp"
    doc = dict(state)
    doc["assignments"] = {str(k): v for k, v in
                          (state.get("assignments") or {}).items()}
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def read_request(pidfile: str) -> Optional[dict]:
    try:
        with open(request_path(pidfile)) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def write_request(pidfile: str, target: str, ts: float) -> None:
    path = request_path(pidfile)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"target": target, "ts": ts}, f)
    os.replace(tmp, path)
