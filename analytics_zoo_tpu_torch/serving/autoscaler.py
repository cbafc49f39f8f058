"""Closed-loop serving autoscaler.

Everything an elastic system needs already exists in the serving plane —
per-replica telemetry registries, lease-based horizontal replicas
with ``manager scale N``, and tunable data-plane knobs
``max_batch`` / ``preprocess_workers`` / ``inflight_batches`` — but
until now nothing closed the loop: capacity was whatever the operator
typed.  This module is the feedback controller:

- **signals** — ``FleetSignals``: one tick's cross-replica observation
  (queue depth + pending, cumulative served/shed/quarantined/reclaimed
  counters, per-stage p99s, per-replica heartbeat ages, current knob and
  topology targets).  Collected from live engines (``EngineFleet``) or
  from the manager supervisor's per-replica health docs (``ManagerFleet``
  via ``serving/fleet.py``) — the SAME aggregation ``manager metrics
  --all-replicas`` prints.
- **policy** — ``AutoscalerPolicy.decide(signals, now)``: a PURE decision
  function (no sleeps, no wall clock of its own — ``now`` is a parameter,
  which is what makes the golden decision-table tests possible).  Two
  actuator tiers with hysteresis:

  * *fast* — in-replica knob nudges: ``max_batch`` doubles/halves within
    the pow-2 bucket ladder, ``inflight_batches`` and
    ``preprocess_workers`` step by one, each gated by ``knob_dwell_s``;
  * *slow* — topology: scale up after overload persists ``dwell_up_s``
    (bounded by ``max_step`` and ``max_replicas``), scale down only after
    ``dwell_down_s`` of underload AND ``scale_down_cooldown_s`` since the
    last scale event (never flap), floored at ``min_replicas``.

  Overload and underload are separated by a dead band (``p99_high`` /
  ``p99_low`` fractions of the SLO, ``backlog_high`` / ``backlog_low``
  micro-batches per replica): signals between the bands HOLD, so the
  controller cannot oscillate around a single threshold.  A replica whose
  heartbeat goes stale (``heartbeat_stale_s``) is REPLACED (per-replica
  ``replace_cooldown_s``) — the SIGKILL-recovery path.

- **runtime** — ``Autoscaler``: a thread ticking every ``interval_s``;
  every action lands in ``autoscaler_decisions_total{action=}``, moves the
  ``autoscaler_target_*`` gauges, appends to a bounded decision log, and
  emits one log line — observable through ``manager metrics`` (the
  supervisor snapshots the controller registry next to the pidfile).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.common.observability import (MetricsRegistry,
                                                          _percentile)

logger = logging.getLogger(__name__)


@dataclass
class FleetSignals:
    """One controller tick's cross-replica observation.  Counters are
    CUMULATIVE (the policy differentiates them into rates between ticks);
    ``replicas`` is the live member count while ``desired`` is the current
    topology target (they differ while a scale event is in flight)."""

    queue_depth: int = 0
    pending: int = 0
    replicas: int = 0
    desired: int = 0
    served_total: float = 0.0
    shed_total: float = 0.0
    quarantined_total: float = 0.0
    reclaimed_total: float = 0.0
    e2e_p99_ms: Optional[float] = None
    preprocess_p99_ms: Optional[float] = None
    predict_p99_ms: Optional[float] = None
    heartbeat_ages: Dict[str, float] = field(default_factory=dict)
    # zero cold start: members still compiling their warm-up set
    # (alive but not yet taking routed traffic) and the fleet's slowest
    # measured spawn-to-first-result — together they tell the controller
    # how stale its own scale-up decisions run (actuation lag)
    replicas_warming: int = 0
    cold_start_s: Optional[float] = None
    # lag-aware prediction: the MEASURED scale_up-decision ->
    # fleet-at-target-and-warm wall from the last actuation
    # (autoscaler_actuation_lag_seconds).  The Autoscaler runtime injects
    # it each tick; the policy projects the backlog this far forward, so
    # capacity lands when the projected load arrives instead of one
    # actuation lag late.  None = never measured -> no lead applied.
    actuation_lag_s: Optional[float] = None
    # current fast-tier targets + their ceilings (from the engines' knobs())
    max_batch: int = 4
    max_batch_ceiling: int = 1024
    inflight_batches: int = 2
    inflight_ceiling: int = 64
    preprocess_workers: int = 1
    # overload armor: the fleet's worst brownout ladder stage
    # (serving/brownout.py; 0 = healthy).  A browned-out fleet is by
    # definition shedding work to protect its SLO — the policy treats
    # stage >= 2 as overload pressure alongside the p99/backlog signals.
    brownout_stage: int = 0


@dataclass
class AutoscalerParams:
    """Controller tuning.  The defaults are deliberately conservative:
    scale-up reacts within a couple of dwell ticks, scale-down waits out
    ``dwell_down_s`` AND ``scale_down_cooldown_s`` so a bursty workload is
    never starved by an eager downscale."""

    slo_p99_ms: float = 500.0          # the latency objective
    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 1.0            # controller tick period
    # hysteresis dead band: overload above the high marks, underload below
    # the low marks, HOLD in between
    p99_high: float = 0.8              # overload when p99 > high * slo
    p99_low: float = 0.3               # underload only when p99 < low * slo
    backlog_high: float = 2.0          # ... backlog > high * max_batch/replica
    backlog_low: float = 0.25
    dwell_up_s: float = 2.0            # overload must persist this long
    dwell_down_s: float = 10.0         # underload must persist this long
    scale_down_cooldown_s: float = 30.0  # after ANY scale event
    max_step: int = 2                  # replicas added/removed per decision
    knob_dwell_s: float = 1.0          # min gap between fast-tier nudges
    max_preprocess_workers: int = 8
    # lag-aware scale-up lead: project the backlog forward by the
    # measured actuation lag (capped at max_lead_s so one pathological
    # measurement cannot make every gentle ramp read as overload).
    # predictive=False restores the reactive-only controller.
    predictive: bool = True
    max_lead_s: float = 30.0
    heartbeat_stale_s: float = 10.0    # replica presumed dead past this
    replace_cooldown_s: float = 10.0   # per-replica, between replacements

    @classmethod
    def from_dict(cls, d: Dict) -> "AutoscalerParams":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


@dataclass
class Action:
    """One controller decision.  ``kind`` is the metrics label
    (``autoscaler_decisions_total{action=kind}``); ``target`` is the new
    replica count (scale), the replica id (replace), or None; ``knobs``
    carries the fast-tier nudge for retune actions."""

    kind: str                          # scale_up | scale_down |
    #                                    replace_replica | retune_up |
    #                                    retune_down
    reason: str
    target: Optional[object] = None
    knobs: Optional[Dict] = None


class AutoscalerPolicy:
    """The pure decision core.  All state is explicit instance state
    mutated only inside ``decide(signals, now)``; time enters ONLY through
    the ``now`` parameter, so tests drive the whole hysteresis / dwell /
    cooldown machinery with a fake clock and synthetic signals."""

    def __init__(self, params: Optional[AutoscalerParams] = None):
        self.params = params or AutoscalerParams()
        self._prev: Optional[FleetSignals] = None
        self._prev_now: Optional[float] = None
        self._overload_since: Optional[float] = None
        self._underload_since: Optional[float] = None
        self._last_scale: float = float("-inf")
        self._last_knob: float = float("-inf")
        self._last_replace: Dict[str, float] = {}
        self._baseline_knobs: Optional[Dict] = None

    # -- derived quantities ---------------------------------------------------
    def _rates(self, s: FleetSignals, now: float) -> Dict[str, float]:
        prev, prev_now = self._prev, self._prev_now
        self._prev, self._prev_now = s, now
        if prev is None or prev_now is None or now <= prev_now:
            return {"shed": 0.0, "reclaim": 0.0, "quarantine": 0.0,
                    "backlog_rate": 0.0}
        dt = now - prev_now
        backlog = max(0, s.queue_depth) + max(0, s.pending)
        prev_backlog = max(0, prev.queue_depth) + max(0, prev.pending)
        # max(0, ...): a replaced external member's counters leaving the sum
        # reads as a negative delta — clamp rather than poison the rate
        return {
            "shed": max(0.0, s.shed_total - prev.shed_total) / dt,
            "reclaim": max(0.0, s.reclaimed_total - prev.reclaimed_total)
            / dt,
            "quarantine": max(0.0, s.quarantined_total
                              - prev.quarantined_total) / dt,
            # signed: the predictive term only uses growth (> 0), but the
            # sign is useful in reasons/logs
            "backlog_rate": (backlog - prev_backlog) / dt}

    # -- the decision function ------------------------------------------------
    def decide(self, s: FleetSignals, now: float) -> List[Action]:
        p = self.params
        if self._baseline_knobs is None and s.replicas > 0:
            # the knob relax tier returns toward the operator's initial
            # settings, never below — swings must not ratchet the knobs.
            # Captured only from a tick with REAL members: before the
            # first replica reports (manager replicas spend seconds in
            # model load), the signals carry placeholder knob defaults,
            # and baselining to those would relax a configured deployment
            # down to them
            self._baseline_knobs = {
                "max_batch": s.max_batch,
                "inflight_batches": s.inflight_batches,
                "preprocess_workers": s.preprocess_workers}
        actions: List[Action] = []

        # 0) dead-replica replacement — independent of the load bands: a
        # stale heartbeat means orphaned leases and lost capacity either way
        for rid, age in sorted(s.heartbeat_ages.items()):
            if age <= p.heartbeat_stale_s:
                continue
            if now - self._last_replace.get(rid, float("-inf")) \
                    < p.replace_cooldown_s:
                continue
            self._last_replace[rid] = now
            actions.append(Action(
                "replace_replica", target=rid,
                reason=f"heartbeat stale {age:.1f}s > "
                       f"{p.heartbeat_stale_s:g}s"))

        rates = self._rates(s, now)
        desired = max(1, s.desired or s.replicas or 1)
        backlog = max(0, s.queue_depth) + max(0, s.pending)
        batch_quantum = max(1, s.max_batch) * desired
        p99 = s.e2e_p99_ms
        # lag-aware lead: new capacity arrives one MEASURED
        # actuation lag after the decision, so judge the backlog where it
        # will be when the replicas are actually warm — a growing backlog
        # crosses the overload band one lead earlier, a shrinking or flat
        # one is unaffected (and underload always judges the RAW backlog,
        # so prediction can never cause a scale-down)
        projected = backlog
        if p.predictive and s.actuation_lag_s \
                and rates["backlog_rate"] > 0:
            lead = min(float(s.actuation_lag_s), p.max_lead_s)
            projected = backlog + rates["backlog_rate"] * lead
        overload = ((p99 is not None and p99 > p.p99_high * p.slo_p99_ms)
                    or projected > p.backlog_high * batch_quantum
                    or rates["shed"] > 0
                    # brownout: a replica deep in the degradation
                    # ladder is already sacrificing quality — treat it as
                    # overload so capacity arrives before stage 3 sheds
                    or s.brownout_stage >= 2)
        underload = (backlog < p.backlog_low * batch_quantum
                     and rates["shed"] == 0
                     and s.brownout_stage == 0
                     and (p99 is None or p99 < p.p99_low * p.slo_p99_ms))

        # hysteresis bookkeeping: the dead band resets BOTH dwell timers, so
        # a borderline workload never accumulates dwell credit
        if overload:
            if self._overload_since is None:   # not `or now`: a dwell that
                self._overload_since = now     # started at t=0.0 is falsy
            self._underload_since = None
        elif underload:
            if self._underload_since is None:
                self._underload_since = now
            self._overload_since = None
        else:
            self._overload_since = self._underload_since = None

        # 1) fast tier: in-replica knob nudges, one per knob_dwell_s
        if overload and now - self._last_knob >= p.knob_dwell_s:
            knob = self._knob_up(s, p)
            if knob is not None:
                self._last_knob = now
                actions.append(Action("retune_up", knobs=knob,
                                      reason=self._band_reason(
                                          s, rates, backlog, batch_quantum,
                                          projected)))
        elif underload and now - self._last_knob >= p.knob_dwell_s:
            knob = self._knob_down(s)
            if knob is not None:
                self._last_knob = now
                actions.append(Action(
                    "retune_down", knobs=knob,
                    reason="underload: relaxing toward baseline"))

        # 2) slow tier: topology.  Scale-up re-arms its own dwell so a
        # still-climbing backlog pays a fresh dwell per step (max_step
        # bounds each step; the re-armed dwell bounds the step RATE).
        if overload and self._overload_since is not None \
                and now - self._overload_since >= p.dwell_up_s \
                and desired < p.max_replicas:
            target = min(desired + p.max_step, p.max_replicas)
            self._last_scale = now
            self._overload_since = now
            actions.append(Action(
                "scale_up", target=target,
                reason=self._band_reason(s, rates, backlog, batch_quantum,
                                         projected)))
        elif underload and self._underload_since is not None \
                and now - self._underload_since >= p.dwell_down_s \
                and now - self._last_scale >= p.scale_down_cooldown_s \
                and desired > p.min_replicas:
            target = max(desired - p.max_step, p.min_replicas)
            self._last_scale = now
            self._underload_since = now
            actions.append(Action(
                "scale_down", target=target,
                reason=f"underload: backlog {backlog} < "
                       f"{p.backlog_low:g}x{batch_quantum}, p99 "
                       f"{'n/a' if p99 is None else f'{p99:.0f}ms'} < "
                       f"{p.p99_low * p.slo_p99_ms:.0f}ms"))
        return actions

    @staticmethod
    def _band_reason(s: FleetSignals, rates, backlog, quantum,
                     projected=None) -> str:
        bits = []
        if s.e2e_p99_ms is not None:
            bits.append(f"p99 {s.e2e_p99_ms:.0f}ms")
        bits.append(f"backlog {backlog}/{quantum}")
        if projected is not None and projected > backlog:
            bits.append(
                f"projected {projected:.0f} in {s.actuation_lag_s:.1f}s "
                f"lag ({rates['backlog_rate']:+.1f}/s)")
        if rates["shed"] > 0:
            bits.append(f"shedding {rates['shed']:.1f}/s")
        return "overload: " + ", ".join(bits)

    def _knob_up(self, s: FleetSignals, p: AutoscalerParams) \
            -> Optional[Dict]:
        """The fast-tier ladder: widen the micro-batch first (pow-2 double,
        the cheapest capacity), then deepen the device pipeline, then grow
        the decode pool — the last only when preprocess, not predict, is
        the measured long pole."""
        if s.max_batch < s.max_batch_ceiling:
            return {"max_batch": min(s.max_batch * 2, s.max_batch_ceiling)}
        if s.inflight_batches < s.inflight_ceiling:
            return {"inflight_batches": s.inflight_batches + 1}
        pre_dominant = (s.preprocess_p99_ms is not None
                        and (s.predict_p99_ms is None
                             or s.preprocess_p99_ms >= s.predict_p99_ms))
        if pre_dominant and s.preprocess_workers < p.max_preprocess_workers:
            return {"preprocess_workers": s.preprocess_workers + 1}
        return None

    def _knob_down(self, s: FleetSignals) -> Optional[Dict]:
        if self._baseline_knobs is None:
            return None                    # no real members seen yet
        base = self._baseline_knobs
        if s.max_batch > base.get("max_batch", s.max_batch):
            return {"max_batch": max(s.max_batch // 2,
                                     base["max_batch"])}
        if s.inflight_batches > base.get("inflight_batches",
                                         s.inflight_batches):
            return {"inflight_batches": s.inflight_batches - 1}
        if s.preprocess_workers > base.get("preprocess_workers",
                                           s.preprocess_workers):
            return {"preprocess_workers": s.preprocess_workers - 1}
        return None


class Autoscaler:
    """The controller runtime: tick -> collect signals -> decide -> actuate
    -> record.  ``fleet`` is any object with ``signals() -> FleetSignals``,
    ``scale_to(n)``, ``retune(**knobs)`` and ``replace(replica_id)`` —
    ``EngineFleet`` (in-process) and ``ManagerFleet`` (supervisor) below
    are the two shipped implementations."""

    DECISION_LOG = 256

    def __init__(self, fleet, params: Optional[AutoscalerParams] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.params = params or AutoscalerParams()
        self.policy = AutoscalerPolicy(self.params)
        self.registry = registry or MetricsRegistry()
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._decisions: deque = deque(maxlen=self.DECISION_LOG)
        reg = self.registry
        self._m_decisions = reg.counter(
            "autoscaler_decisions_total",
            "Controller actions taken, by kind", labels=("action",))
        for kind in ("scale_up", "scale_down", "replace_replica",
                     "retune_up", "retune_down"):
            self._m_decisions.labels(action=kind).inc(0)
        self._m_ticks = reg.counter(
            "autoscaler_ticks_total", "Controller evaluation ticks")
        self._g_replicas = reg.gauge(
            "autoscaler_target_replicas", "Current topology target")
        self._g_max_batch = reg.gauge(
            "autoscaler_target_max_batch", "Current max_batch knob target")
        self._g_inflight = reg.gauge(
            "autoscaler_target_inflight",
            "Current inflight_batches knob target")
        self._g_pre = reg.gauge(
            "autoscaler_target_preprocess_workers",
            "Current preprocess_workers knob target")
        self._g_p99 = reg.gauge(
            "autoscaler_observed_p99_ms",
            "Fleet e2e p99 at the last controller tick")
        # actuation lag: scale_up decision -> every new member
        # alive AND warm.  The whole point of zero-cold-start replicas is
        # shrinking this number — with it measured, a predictive policy
        # term has something to be judged against.
        self._g_lag = reg.gauge(
            "autoscaler_actuation_lag_seconds",
            "Last scale_up decision to fleet-at-target-and-warm")
        self._g_warming = reg.gauge(
            "autoscaler_replicas_warming",
            "Members still compiling their warm-up set")
        self._pending_scale: Optional[tuple] = None  # (t_decided, target)
        # last measured actuation lag, fed back into the policy's
        # predictive term: the controller learns its own latency
        self._last_lag: Optional[float] = None

    # -- one evaluation -------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Action]:
        now = self._clock() if now is None else now
        try:
            signals = self.fleet.signals()
        except Exception as e:  # noqa: BLE001 — a dead collector must not
            logger.warning("autoscaler: signal collection failed (%s: %s)",
                           type(e).__name__, e)   # kill the control loop
            return []
        self._m_ticks.inc()
        self._g_p99.set(signals.e2e_p99_ms
                        if signals.e2e_p99_ms is not None else float("nan"))
        self._g_warming.set(float(signals.replicas_warming))
        if self._pending_scale is not None:
            t_req, target = self._pending_scale
            if signals.replicas >= target and signals.replicas_warming == 0:
                lag = max(0.0, now - t_req)
                self._g_lag.set(lag)
                self._last_lag = lag
                self._pending_scale = None
                logger.info(
                    "autoscaler: scale-up actuated — %d replica(s) alive "
                    "and warm %.2fs after the decision (fleet cold-start "
                    "%s)", target, lag,
                    f"{signals.cold_start_s:.2f}s"
                    if signals.cold_start_s is not None else "n/a")
        if signals.actuation_lag_s is None:
            # feed the measured closed-loop latency back into the policy's
            # predictive term; a fleet that reports its own lag (future
            # signal sources) wins over our local measurement
            signals.actuation_lag_s = self._last_lag
        actions = self.policy.decide(signals, now)
        for act in actions:
            self._apply(act, signals)
            if act.kind == "scale_up":
                self._pending_scale = (now, int(act.target))
            elif act.kind == "scale_down":
                # the fleet is shrinking: a pending lag measurement would
                # trivially "complete" at the lower target — drop it
                self._pending_scale = None
        # current targets AFTER this tick's actions
        self._g_replicas.set(getattr(self.fleet, "desired", signals.desired))
        self._g_max_batch.set(signals.max_batch)
        self._g_inflight.set(signals.inflight_batches)
        self._g_pre.set(signals.preprocess_workers)
        return actions

    def _apply(self, act: Action, signals: FleetSignals) -> None:
        self._m_decisions.labels(action=act.kind).inc()
        entry = {"ts": time.time(), "action": act.kind,
                 "target": act.target, "knobs": act.knobs,
                 "reason": act.reason}
        self._decisions.append(entry)
        # incident flight recorder: every actuated decision lands
        # on the process timeline next to LB/lifecycle events, so an
        # incident bundle shows WHAT the controller did around the burn
        try:
            from analytics_zoo_tpu_torch.common.observability import \
                get_recorder
            get_recorder().record(
                "autoscale", action=act.kind,
                target=act.target, reason=str(act.reason)[:200])
        except Exception:  # noqa: BLE001 — diagnostics only
            pass
        logger.info(
            "autoscaler: %s target=%s knobs=%s (%s) [depth=%d pending=%d "
            "replicas=%d/%d]", act.kind, act.target, act.knobs, act.reason,
            signals.queue_depth, signals.pending, signals.replicas,
            signals.desired)
        try:
            if act.kind in ("scale_up", "scale_down"):
                self.fleet.scale_to(int(act.target))
            elif act.kind == "replace_replica":
                self.fleet.replace(act.target)
            elif act.kind in ("retune_up", "retune_down"):
                self.fleet.retune(**(act.knobs or {}))
        except Exception as e:  # noqa: BLE001 — an actuator failure is
            # logged and retried by a later tick, never fatal to the loop
            logger.warning("autoscaler: actuating %s failed (%s: %s)",
                           act.kind, type(e).__name__, e)

    def decisions(self) -> List[Dict]:
        return list(self._decisions)

    def snapshot(self) -> Dict:
        """Machine-readable controller state: registry snapshot + the
        decision log — what the manager supervisor persists next to the
        pidfile so ``manager metrics`` can show it."""
        return {"ts": time.time(),
                "params": dict(self.params.__dict__),
                "metrics": self.registry.snapshot(),
                "prom": self.registry.to_prometheus(),
                "decisions": self.decisions()}

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Autoscaler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.params.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must live
                logger.exception("autoscaler: tick failed")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


# -- in-process fleet (bench, tests, embedded serving) ------------------------

class EngineFleet:
    """An in-process replica fleet over ONE shared queue: the Autoscaler's
    actuator and signal source when the replicas are ClusterServing engines
    in this process (the bench and the chaos tests; production uses
    ``ManagerFleet`` over supervisor-forked processes).

    ``factory(replica_id) -> started ClusterServing`` builds a member;
    engines share the queue object and (typically) one InferenceModel.
    External members — e.g. a subprocess replica the chaos bench will
    SIGKILL — join via ``add_external(replica_id, heartbeat_fn,
    stats_fn)`` and are counted in the fleet signals; replacing one swaps
    in an in-process engine."""

    def __init__(self, factory: Callable[[str], object], queue,
                 initial: int = 1, name_prefix: str = "as",
                 drain_s: float = 2.0):
        self._factory = factory
        self.queue = queue
        self._prefix = name_prefix
        self._drain_s = drain_s
        self._lock = threading.Lock()
        self._engines: Dict[str, object] = {}
        self._external: Dict[str, Dict] = {}   # rid -> {heartbeat, stats}
        self._seq = 0
        self.desired = 0
        self.scale_to(max(0, int(initial)))

    # -- membership -----------------------------------------------------------
    def engines(self) -> List[object]:
        with self._lock:
            return list(self._engines.values())

    def add_external(self, replica_id: str,
                     heartbeat_fn: Callable[[], Optional[float]],
                     stats_fn: Optional[Callable[[], Optional[Dict]]]
                     = None) -> None:
        """Adopt a member this process does not own (a subprocess replica).
        ``heartbeat_fn() -> age seconds`` (None = unknown/gone);
        ``stats_fn() -> health-doc-like dict`` contributes its counters."""
        with self._lock:
            self._external[replica_id] = {"heartbeat": heartbeat_fn,
                                          "stats": stats_fn}
            self.desired += 1

    def _spawn_locked(self) -> str:
        self._seq += 1
        rid = f"{self._prefix}-{self._seq}"
        self._engines[rid] = self._factory(rid)
        return rid

    def scale_to(self, n: int) -> None:
        n = max(0, int(n))
        to_stop: List[object] = []
        with self._lock:
            self.desired = n
            while len(self._engines) + len(self._external) < n:
                self._spawn_locked()
            # scale-down: newest engines first; externals are never stopped
            # from here (this process doesn't own them)
            while len(self._engines) + len(self._external) > n \
                    and self._engines:
                # newest first, by spawn sequence (lexicographic sorting
                # would retire as-9 before as-10)
                rid = max(self._engines,
                          key=lambda r: int(r.rsplit("-", 1)[-1])
                          if r.rsplit("-", 1)[-1].isdigit() else -1)
                to_stop.append(self._engines.pop(rid))
        for engine in to_stop:
            # scale-down drain: flush this replica's in-flight work but
            # leave the SHARED queue's admission open for the survivors
            engine.shutdown(drain_s=self._drain_s, close_admission=False)

    def retune(self, **knobs) -> None:
        for engine in self.engines():
            engine.retune(**knobs)

    def replace(self, replica_id: str) -> None:
        """Swap out a dead/wedged member: an engine is hard-stopped (no
        drain — it is presumed wedged; its unacked claims redeliver via the
        lease) and a fresh engine takes its slot; an external member is
        simply dropped and replaced by an in-process engine."""
        dead = None
        with self._lock:
            if replica_id in self._external:
                self._external.pop(replica_id)
                self._spawn_locked()
                return
            for rid, engine in list(self._engines.items()):
                if rid == replica_id \
                        or getattr(engine, "replica_id", None) == replica_id:
                    dead = self._engines.pop(rid)
                    break
            if dead is None:
                return
            self._spawn_locked()
        dead.shutdown(drain_s=0, close_admission=False)

    def shutdown(self) -> None:
        with self._lock:
            engines, self._engines = list(self._engines.values()), {}
            self._external.clear()
            self.desired = 0
        for engine in engines:
            engine.shutdown(drain_s=self._drain_s)

    # -- signal collection ----------------------------------------------------
    @staticmethod
    def _merged_p99_ms(children) -> Optional[float]:
        samples: List[float] = []
        for child in children:
            samples.extend(child.recent())
        if not samples:
            return None
        return _percentile(sorted(samples), 99) * 1e3

    def signals(self) -> FleetSignals:
        engines = self.engines()
        with self._lock:
            external = dict(self._external)
            desired = self.desired
        try:
            qh = self.queue.health()
        except Exception:  # noqa: BLE001 — backend down: zeros, the
            qh = {}        # heartbeats still drive replacement
        served = shed = quarantined = reclaimed = 0.0
        warming = 0
        cold_start = None
        brownout = 0
        hb: Dict[str, float] = {}
        for e in engines:
            served += e.total_records
            shed += e.shed
            quarantined += e.dead_lettered
            reclaimed += e.reclaimed
            brownout = max(brownout, int(getattr(e, "brownout_stage", 0)
                                         or 0))
            hb[e.replica_id] = e._heartbeat_age()
            w = getattr(e, "_warm_state", None) or {}
            if w.get("state") in ("pending", "warming"):
                warming += 1
            cs = getattr(e, "_cold_start_s", None)
            if cs is not None:
                cold_start = cs if cold_start is None \
                    else max(cold_start, cs)
        for rid, ext in external.items():
            age = None
            try:
                age = ext["heartbeat"]()
            except Exception:  # noqa: BLE001 — unreadable = unknown
                pass
            hb[rid] = float("inf") if age is None else float(age)
            stats = None
            if ext["stats"] is not None:
                try:
                    stats = ext["stats"]()
                except Exception:  # noqa: BLE001
                    stats = None
            if isinstance(stats, dict):
                served += stats.get("total_records", 0)
                shed += stats.get("shed", 0)
                quarantined += stats.get("dead_lettered", 0)
                reclaimed += stats.get("reclaimed", 0)
        sig = FleetSignals(
            queue_depth=int(qh.get("depth", 0) or 0),
            pending=max(0, int(qh.get("pending", 0) or 0)),
            replicas=len(engines) + len(external),
            desired=desired,
            served_total=served, shed_total=shed,
            quarantined_total=quarantined, reclaimed_total=reclaimed,
            e2e_p99_ms=self._merged_p99_ms(
                e._e2e._default() for e in engines),
            preprocess_p99_ms=self._merged_p99_ms(
                e._stages["preprocess"] for e in engines),
            predict_p99_ms=self._merged_p99_ms(
                e._stages["predict"] for e in engines),
            heartbeat_ages=hb,
            replicas_warming=warming,
            cold_start_s=cold_start,
            brownout_stage=brownout)
        if engines:
            k = engines[0].knobs()
            sig.max_batch = int(k["max_batch"])
            sig.max_batch_ceiling = int(k["max_batch_ceiling"])
            sig.inflight_batches = int(k["inflight_batches"])
            sig.inflight_ceiling = int(k["inflight_ceiling"])
            sig.preprocess_workers = int(k["preprocess_workers"])
        return sig


# -- manager-supervisor fleet (production topology) ---------------------------

class ManagerFleet:
    """Autoscaler adapter for a ``manager start --replicas N`` deployment:
    signals come from the per-replica health docs (HTTP probe scrape with
    ``<pidfile>.rN.health.json`` fallback — ``serving/fleet.py``), topology
    is actuated through the supervisor's ``<pidfile>.replicas`` scale file
    (exactly what ``manager scale N`` writes), knob nudges through
    ``<pidfile>.knobs.json`` which every replica polls once a second and
    applies via ``ClusterServing.retune()``, and a stale replica is
    replaced by SIGKILLing its pid — the supervisor's crash-respawn loop
    brings up the successor."""

    def __init__(self, pidfile: str, http_host: str = "127.0.0.1",
                 http_port: Optional[int] = None,
                 max_replicas: int = 8):
        self.pidfile = pidfile
        self.http_host = http_host
        self.http_port = http_port
        self.max_replicas = int(max_replicas)

    # the supervisor's files (mirrors serving/manager.py helpers; kept
    # string-level so this module never imports the manager's torch deps)
    @property
    def _scale_path(self) -> str:
        return self.pidfile + ".replicas"

    @property
    def knobs_path(self) -> str:
        return self.pidfile + ".knobs.json"

    @property
    def desired(self) -> int:
        from analytics_zoo_tpu_torch.serving.fleet import read_scale
        return read_scale(self.pidfile)

    def signals(self) -> FleetSignals:
        from analytics_zoo_tpu_torch.serving import fleet as _fleet
        docs = _fleet.replica_docs(self.pidfile, http_host=self.http_host,
                                   http_port=self.http_port,
                                   count=max(self.desired,
                                             self.max_replicas))
        agg = _fleet.aggregate_health(docs)
        knobs = agg.get("knobs") or {}
        return FleetSignals(
            queue_depth=int(agg.get("queue_depth", 0)),
            pending=max(0, int(agg.get("pending", 0))),
            replicas=int(agg.get("replicas_alive", 0)),
            desired=self.desired,
            served_total=float(agg.get("served", 0)),
            shed_total=float(agg.get("shed", 0)),
            quarantined_total=float(agg.get("quarantined", 0)),
            reclaimed_total=float(agg.get("reclaimed", 0)),
            e2e_p99_ms=agg.get("e2e_p99_ms"),
            preprocess_p99_ms=agg.get("preprocess_p99_ms"),
            predict_p99_ms=agg.get("predict_p99_ms"),
            heartbeat_ages=dict(agg.get("heartbeat_ages", {})),
            replicas_warming=int(agg.get("replicas_warming", 0) or 0),
            cold_start_s=agg.get("cold_start_s"),
            brownout_stage=int(agg.get("brownout_stage") or 0),
            max_batch=int(knobs.get("max_batch", 4)),
            max_batch_ceiling=int(knobs.get("max_batch_ceiling", 1024)),
            inflight_batches=int(knobs.get("inflight_batches", 2)),
            inflight_ceiling=int(knobs.get("inflight_ceiling", 64)),
            preprocess_workers=int(knobs.get("preprocess_workers", 1)))

    def scale_to(self, n: int) -> None:
        tmp = self._scale_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(max(0, int(n))))
        os.replace(tmp, self._scale_path)

    def retune(self, **knobs) -> None:
        current: Dict = {}
        try:
            with open(self.knobs_path) as f:
                current = json.load(f) or {}
        except (OSError, ValueError):
            pass
        current.update(knobs)
        tmp = self.knobs_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(current, f)
        os.replace(tmp, self.knobs_path)

    def replace(self, replica_id: str) -> None:
        """SIGKILL the stale replica (it is presumed wedged — a graceful
        SIGTERM could hang in its drain); the supervisor's respawn loop
        starts the replacement within its 1 s rate limit and the survivors
        reclaim the orphaned leases meanwhile."""
        import signal as _signal
        index = str(replica_id).rsplit("-", 1)[-1]
        if not index.isdigit():
            logger.warning("autoscaler: cannot map replica id %r to a "
                           "supervisor slot", replica_id)
            return
        try:
            with open(f"{self.pidfile}.r{index}") as f:
                pid = int(f.read().strip())
            os.kill(pid, _signal.SIGKILL)
            logger.warning("autoscaler: SIGKILLed stale replica %s "
                           "(pid %d); supervisor will respawn it",
                           replica_id, pid)
        except (OSError, ValueError) as e:
            logger.warning("autoscaler: replacing %s failed (%s: %s)",
                           replica_id, type(e).__name__, e)
