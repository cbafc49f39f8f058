"""Tenant-aware admission control: a copy of the JAX package's
``serving/admission.py``.

Without it the front door has one overload answer, the queue's fleet-wide
``max_depth`` 429, applied anonymously: a single misbehaving client
starves every other tenant, and interactive traffic waits behind bulk
scoring.  This module puts a token-bucket admission controller at the
gateway trust edge (the gateway, not the client, stamps identity):

- **Tenant identity** comes from the ``X-Api-Key`` / ``X-Tenant``
  request header, normalized and cardinality-bounded here (unknown or
  over-cardinality tenants share the ``"other"`` bucket so a label-spray
  cannot blow up the metrics registry).
- **Priority class** comes from ``X-Priority`` — ``interactive`` /
  ``batch`` / ``best_effort`` — and defaults to ``batch``; each
  (tenant, priority) pair gets its own bucket so one tenant's bulk lane
  cannot drain its own interactive lane.
- **Rate + burst** are per-tenant configurable with a default for
  everyone else; 429 responses carry a ``Retry-After`` computed from the
  ACTUAL bucket refill time (``deficit / rate``), not a constant — a
  correct client backoff converges on the admitted rate instead of
  thundering at a fixed period.
- **Queue-depth-aware global caps**: each priority class is rejected
  above a configured fraction of the queue's ``max_depth`` (best-effort
  first, interactive last), so lower classes stop ADDING to a backlog
  long before the fleet-wide cap would bounce everyone equally.
- **Brownout coupling**: at ladder stage >= 3 (serving/brownout.py) the
  best-effort class is shed at admission outright.

Decisions are pure given (clock, depth, stage) — every gate is
injectable, so the bucket math and the priority ordering are golden-
testable with a fake clock and no engine.

Pure stdlib; the engine owns the single controller instance and the
gateway consults it per request via ``ClusterServing.admit_record``.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

PRIORITIES = ("interactive", "batch", "best_effort")

# rejection reasons — the `serving_rejected_total{reason=}` label set
REASON_TENANT_RATE = "tenant_rate"
REASON_QUEUE_PRESSURE = "queue_pressure"
REASON_BROWNOUT = "brownout"
REASON_FAULT = "fault"

# tenants are remote-controlled strings: bound the charset AND the
# cardinality before they become metric labels / dict keys
_TENANT_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")
DEFAULT_TENANT = "default"
OTHER_TENANT = "other"
MAX_TENANTS = 64

# above this fraction of queue max_depth, the class is rejected — the
# ordering IS the priority policy: best-effort stops adding to a backlog
# at half depth, interactive only at the fleet-wide cap itself
DEFAULT_DEPTH_FRACTIONS = {
    "best_effort": 0.50,
    "batch": 0.80,
    "interactive": 1.00,
}


def normalize_priority(value) -> str:
    """Clamp a remote-supplied priority to the known class set.
    Unknown / missing values land in ``batch`` — neither promoted into
    the interactive lane nor silently discarded with best-effort."""
    if isinstance(value, str):
        v = value.strip().lower().replace("-", "_")
        if v in PRIORITIES:
            return v
    return "batch"


def normalize_tenant(value) -> str:
    """Clamp a remote-supplied tenant id: missing -> ``default``,
    junk-shaped -> ``other`` (never a raw client string into labels)."""
    if value is None or value == "":
        return DEFAULT_TENANT
    if isinstance(value, str) and _TENANT_RE.match(value):
        return value
    return OTHER_TENANT


def pressure_level(staged_frac: float, depth_frac: float,
                   brownout_stage: int) -> int:
    """Engine-side shed aggressiveness from three cheap signals:
    0 = none, 1 = shed best_effort, 2 = shed best_effort AND batch.
    Pure — the priority-shed ordering tests drive it directly."""
    level = 0
    if staged_frac >= 1.0 or depth_frac >= 0.5 or brownout_stage >= 3:
        level = 1
    if depth_frac >= 0.9 and staged_frac >= 1.0:
        level = 2
    return level


def shed_classes(level: int):
    """Priority classes shed at a given pressure level, lowest first."""
    if level >= 2:
        return ("best_effort", "batch")
    if level >= 1:
        return ("best_effort",)
    return ()


def deadline_unmeetable(remaining_s: float, backlog_batches: int,
                        batch_ewma_s: Optional[float]) -> bool:
    """Early-drop gate: can a record claimed NOW still make its deadline
    through the current backlog?  ``batch_ewma_s`` is the engine's
    smoothed per-batch service time (None until the first batch lands —
    never drop on a guess).  Conservative by one batch: the record's own
    batch must also run."""
    if batch_ewma_s is None or batch_ewma_s <= 0.0:
        return False
    if remaining_s <= 0.0:
        return True          # already expired — the plain shed gate's job,
    est = (max(0, backlog_batches) + 1) * batch_ewma_s
    return remaining_s < est


class TokenBucket:
    """Classic token bucket with refill-derived retry hints.  NOT
    thread-safe on its own — the controller serializes access."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = float(now)

    def try_acquire(self, now: float, n: float = 1.0) -> float:
        """Refill to ``now`` and take ``n`` tokens.  Returns 0.0 when
        admitted, else the seconds until ``n`` tokens WILL be available
        (the computed ``Retry-After``)."""
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = max(self._last, now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class Decision(NamedTuple):
    admitted: bool
    reason: Optional[str]          # None when admitted
    retry_after_s: float           # > 0 on rejection — the backoff hint
    tenant: str
    priority: str


class AdmissionController:
    """The per-replica admission gate.  Config (``params.admission``)::

        admission:
          enabled: true
          rate: 100.0        # records/s per (tenant, priority) bucket
          burst: 200.0       # bucket depth (default 2x rate)
          tenants:           # per-tenant overrides
            gold: {rate: 500.0, burst: 1000.0}
          depth_fractions:   # per-class queue-depth rejection thresholds
            best_effort: 0.5
            batch: 0.8
            interactive: 1.0
    """

    def __init__(self, config: Optional[Dict],
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 queue_depth_fn: Optional[Callable[[], Optional[int]]] = None,
                 max_depth: Optional[int] = None,
                 brownout_stage_fn: Optional[Callable[[], int]] = None,
                 faults=None):
        cfg = config if isinstance(config, dict) else {}
        self.enabled = bool(cfg.get("enabled", True))
        self._clock = clock
        self._depth_fn = queue_depth_fn
        self._max_depth = int(max_depth) if max_depth else None
        self._stage_fn = brownout_stage_fn
        self._faults = faults
        self._rate = self._pos_float(cfg.get("rate"), 100.0)
        self._burst = self._pos_float(cfg.get("burst"), 2.0 * self._rate)
        self._tenant_cfg: Dict[str, Dict] = {
            str(k): v for k, v in (cfg.get("tenants") or {}).items()
            if isinstance(v, dict)}
        fractions = dict(DEFAULT_DEPTH_FRACTIONS)
        for k, v in (cfg.get("depth_fractions") or {}).items():
            k = normalize_priority(k) if k in PRIORITIES else k
            if k in fractions:
                try:
                    fractions[k] = min(1.0, max(0.0, float(v)))
                except (TypeError, ValueError):
                    pass
        self._fractions = fractions
        self._max_tenants = int(cfg.get("max_tenants", MAX_TENANTS))
        self._buckets: Dict[tuple, TokenBucket] = {}
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected = 0
        self._by_reason: Dict[str, int] = {}
        self._m_admitted = self._m_rejected = None
        if registry is not None:
            self._m_admitted = registry.counter(
                "serving_admitted_total",
                "Records admitted at the gate, by tenant and priority",
                labels=("tenant", "priority"))
            self._m_rejected = registry.counter(
                "serving_rejected_total",
                "Records rejected at the gate, by reason",
                labels=("reason",))
            # materialize the reason series at zero so dashboards see
            # the label set before the first rejection
            for reason in (REASON_TENANT_RATE, REASON_QUEUE_PRESSURE,
                           REASON_BROWNOUT, REASON_FAULT):
                self._m_rejected.labels(reason=reason).inc(0)

    @staticmethod
    def _pos_float(v, default: float) -> float:
        try:
            f = float(v)
            return f if f > 0 else default
        except (TypeError, ValueError):
            return default

    # -- per-tenant bucket parameters ------------------------------------
    def _tenant_params(self, tenant: str) -> tuple:
        cfg = self._tenant_cfg.get(tenant)
        if cfg is not None:
            rate = self._pos_float(cfg.get("rate"), self._rate)
            burst = self._pos_float(cfg.get("burst"), 2.0 * rate)
            return rate, burst
        return self._rate, self._burst

    def _bucket(self, tenant: str, priority: str, now: float) -> TokenBucket:
        key = (tenant, priority)
        b = self._buckets.get(key)
        if b is None:
            # cardinality bound: once the table is full, every NEW
            # unconfigured tenant shares the "other" bucket — a tenant-id
            # spray degrades to one shared lane instead of unbounded state
            if len(self._buckets) >= self._max_tenants * len(PRIORITIES) \
                    and tenant not in self._tenant_cfg \
                    and tenant != OTHER_TENANT:
                return self._bucket(OTHER_TENANT, priority, now)
            rate, burst = self._tenant_params(tenant)
            b = self._buckets[key] = TokenBucket(rate, burst, now)
        return b

    # -- the decision -----------------------------------------------------
    def admit(self, tenant=None, priority=None,
              now: Optional[float] = None) -> Decision:
        tenant = normalize_tenant(tenant)
        priority = normalize_priority(priority)
        if not self.enabled:
            return self._admit(tenant, priority)
        if now is None:
            now = self._clock()
        with self._lock:
            # deterministic chaos hook (serving/faults.py admission_reject)
            if self._faults is not None and \
                    self._faults.take_admission_reject(priority):
                return self._reject(REASON_FAULT, 1.0, tenant, priority)
            # brownout stage 3: the ladder's last rung before hard
            # overload — best-effort is shed at the door
            if priority == "best_effort" and self._stage_fn is not None:
                try:
                    stage = int(self._stage_fn() or 0)
                except Exception:  # noqa: BLE001 — gate must not raise
                    stage = 0
                if stage >= 3:
                    return self._reject(REASON_BROWNOUT, 2.0,
                                        tenant, priority)
            # queue-depth-aware class caps: stop lower classes from
            # ADDING to a backlog well before the fleet-wide 429
            frac = self._depth_fraction()
            if frac is not None and frac >= self._fractions[priority]:
                return self._reject(REASON_QUEUE_PRESSURE, 1.0,
                                    tenant, priority)
            # the (tenant, priority) bucket itself
            retry = self._bucket(tenant, priority, now).try_acquire(now)
            if retry > 0.0:
                return self._reject(REASON_TENANT_RATE, retry,
                                    tenant, priority)
            return self._admit(tenant, priority)

    def _depth_fraction(self) -> Optional[float]:
        if self._depth_fn is None or not self._max_depth:
            return None
        try:
            depth = self._depth_fn()
        except Exception:  # noqa: BLE001 — backend down is not a reject
            return None
        if depth is None:
            return None
        return float(depth) / float(self._max_depth)

    def _admit(self, tenant: str, priority: str) -> Decision:
        self.admitted += 1
        if self._m_admitted is not None:
            self._m_admitted.labels(tenant=tenant, priority=priority).inc()
        return Decision(True, None, 0.0, tenant, priority)

    def _reject(self, reason: str, retry_after_s: float,
                tenant: str, priority: str) -> Decision:
        self.rejected += 1
        self._by_reason[reason] = self._by_reason.get(reason, 0) + 1
        if self._m_rejected is not None:
            self._m_rejected.labels(reason=reason).inc()
        return Decision(False, reason, max(0.05, float(retry_after_s)),
                        tenant, priority)

    def snapshot(self) -> Dict:
        """The ``health()["admission"]`` block."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "rejected_by_reason": dict(self._by_reason),
                "buckets": len(self._buckets),
                "default_rate": self._rate,
                "default_burst": self._burst,
                "tenants_configured": sorted(self._tenant_cfg),
            }
