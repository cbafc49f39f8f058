"""Usage metering and attribution: a copy of the JAX package's
``serving/metering.py``, the dimensional observability surface under
per-tenant billing, quotas and SLO views.

One ``UsageMeter`` per engine owns every ``{tenant=,model=}`` labelled
series and the per-interval usage journal a manager drains next to the
trace/event spools:

- ``serving_records_total{tenant=,model=}`` — records served
- ``serving_generated_tokens_total{tenant=,model=}`` — generation tokens,
  charged at each continuous-batcher step boundary
- ``serving_sheds_total{tenant=,model=}`` — records shed/dead-lettered,
  attributed to the tenant that lost them (the fleet-scalar
  ``serving_shed_total`` keeps its meaning)
- ``serving_device_seconds_total{tenant=,model=}`` — measured dispatch
  wall time apportioned per batch by row count; Σ over tenants equals
  engine busy time by construction (conservation is test-asserted)
- ``serving_request_seconds{tenant=,model=}`` — end-to-end latency
  histogram per tenant
- ``serving_slo_burn_rate{tenant=}`` — per-tenant :class:`SloTracker`
  views next to the fleet-global bare sample

Cardinality is bounded by the admission normalizer: tenant ids are
already normalized at the trust edge, and the meter additionally folds
any tenant past ``max_tenants`` distinct ids into ``tenant="other"`` so
a tenant-id sweep cannot grow the exposition without bound.  Records
that arrive without identity (legacy producers, old wire frames) are
attributed to ``tenant="unknown"``.

With ``enabled: false`` the meter registers the UNLABELLED
``serving_records_total``/``serving_generated_tokens_total`` series and
compiles the journal/attribution hop down to a counter bump.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common.observability import (MetricsRegistry,
                                                          SloTracker)
from analytics_zoo_tpu_torch.serving.admission import (DEFAULT_TENANT,
                                                       MAX_TENANTS,
                                                       OTHER_TENANT,
                                                       normalize_tenant)

UNKNOWN_TENANT = "unknown"     # records that arrived without identity

_USAGE_FIELDS = ("records", "tokens", "device_s", "bytes", "sheds")


class UsageMeter:
    """Per-engine attribution ledger: labelled series + journal deltas.

    Thread-safe — the read loop, write stage, and generation scheduler
    all charge usage concurrently.  ``drain()`` hands the accumulated
    per-(tenant, model) deltas to the journal writer and resets them,
    so each journal record is a per-interval delta (billing-grade:
    replaying the journal reproduces the counters).
    """

    def __init__(self, registry: MetricsRegistry,
                 model: Optional[str] = None,
                 cfg: Optional[Dict] = None,
                 tenants_configured: Tuple[str, ...] = (),
                 slo_defaults: Optional[Dict] = None):
        cfg = cfg if isinstance(cfg, dict) else {}
        self.enabled = bool(cfg.get("enabled", True))
        self.model = str(model) if model else "default"
        try:
            self.max_tenants = max(1, int(cfg.get("max_tenants",
                                                  MAX_TENANTS)))
        except (TypeError, ValueError):
            self.max_tenants = MAX_TENANTS
        self._registry = registry
        self._lock = threading.Lock()
        self._seen: set = set()
        # per-tenant labelled-child handles: labels() takes the metric
        # lock and rebuilds its key on every call, so the hot path
        # (records/tokens per record served) goes through this cache —
        # reads are GIL-atomic, a racing duplicate build is idempotent
        # (labels() returns the same child)
        self._handles: Dict[str, Tuple] = {}
        self._pending: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._totals: Dict[Tuple[str, str], Dict[str, float]] = {}
        # per-tenant SLO views: explicit objectives from the metering
        # block, falling back to the fleet objective for every other
        # tenant that shows traffic (None = no per-tenant views)
        self._slo_cfg = cfg.get("slo_objectives") \
            if isinstance(cfg.get("slo_objectives"), dict) else {}
        self._slo_defaults = slo_defaults \
            if isinstance(slo_defaults, dict) else None
        # no objective anywhere = the per-record slo_observe hop is a
        # single attribute test, not a lock + tracker lookup
        self._slo_possible = bool(self._slo_cfg) \
            or self._slo_defaults is not None
        self._slo: Dict[str, SloTracker] = {}
        if self.enabled:
            lbl = ("tenant", "model")
            self._m_records = registry.counter(
                "serving_records_total", "Records served", labels=lbl)
            self._m_tokens = registry.counter(
                "serving_generated_tokens_total",
                "Tokens emitted by the generation scheduler", labels=lbl)
            self._m_sheds = registry.counter(
                "serving_sheds_total",
                "Records shed or dead-lettered, attributed to the tenant "
                "that lost them", labels=lbl)
            self._m_device = registry.counter(
                "serving_device_seconds_total",
                "Measured dispatch wall time apportioned per batch by "
                "row count", labels=lbl)
            self._m_request = registry.histogram(
                "serving_request_seconds",
                "End-to-end request latency per tenant", labels=lbl)
            # materialized at 0 for every config-listed tenant, so
            # dashboards and the fleet merge don't flap on first traffic
            for t in tenants_configured:
                t = normalize_tenant(t)
                self._seen.add(t)
                self._h(t)          # creates every labelled child at 0
                self._slo_tracker(t)
        else:
            # metering off: the unlabelled series
            self._m_records = registry.counter(
                "serving_records_total", "Records served")
            self._m_tokens = registry.counter(
                "serving_generated_tokens_total",
                "Tokens emitted by the generation scheduler")
            self._m_sheds = self._m_device = self._m_request = None

    # -- tenant folding --------------------------------------------------------

    def resolve(self, tenant: Optional[str]) -> str:
        """Fold one record's tenant into a bounded label value: absent ->
        ``unknown``, junk -> normalized, past ``max_tenants`` distinct
        ids -> ``other``."""
        if not tenant:
            return UNKNOWN_TENANT
        if tenant in self._seen:
            # hot path: the engine hoist already normalized the id, and a
            # seen id can never fold differently again — GIL-atomic read,
            # no lock
            return tenant
        t = normalize_tenant(tenant)
        if t in (OTHER_TENANT, UNKNOWN_TENANT, DEFAULT_TENANT):
            return t
        with self._lock:
            if t in self._seen:
                return t
            if len(self._seen) >= self.max_tenants:
                return OTHER_TENANT
            self._seen.add(t)
            return t

    def _h(self, t: str) -> Tuple:
        """(records, tokens, sheds, device, request) labelled children
        for one resolved tenant, built once."""
        h = self._handles.get(t)
        if h is None:
            h = self._handles[t] = tuple(
                m.labels(tenant=t, model=self.model)
                for m in (self._m_records, self._m_tokens, self._m_sheds,
                          self._m_device, self._m_request))
        return h

    # -- charging --------------------------------------------------------------

    def _charge(self, tenant: Optional[str], field: str, n: float) -> str:
        # single-ledger hot path: only the pending interval is written per
        # charge; drain()/snapshot() fold it into the cumulative totals
        t = self.resolve(tenant)
        key = (t, self.model)
        with self._lock:
            pend = self._pending.get(key)
            if pend is None:
                pend = self._pending[key] = dict.fromkeys(_USAGE_FIELDS,
                                                          0.0)
            pend[field] += n
        return t

    def records(self, tenant: Optional[str], n: int = 1) -> None:
        if not self.enabled:
            self._m_records.inc(n)
            return
        t = self._charge(tenant, "records", n)
        self._h(t)[0].inc(n)

    def tokens(self, tenant: Optional[str], n: int) -> None:
        if not self.enabled:
            self._m_tokens.inc(n)
            return
        if n <= 0:
            return
        t = self._charge(tenant, "tokens", n)
        self._h(t)[1].inc(n)

    def sheds(self, tenant: Optional[str], n: int = 1) -> None:
        if not self.enabled:
            return
        t = self._charge(tenant, "sheds", n)
        self._h(t)[2].inc(n)

    def wire_bytes(self, tenant: Optional[str], n: int) -> None:
        if not self.enabled or n <= 0:
            return
        self._charge(tenant, "bytes", n)

    def device_seconds(self, rows_by_tenant: Dict[Optional[str], int],
                       wall_s: float) -> None:
        """Apportion one batch's measured dispatch wall time by row
        count.  Σ over tenants == ``wall_s`` exactly (up to float
        rounding), which is what makes the conservation invariant
        (Σ tenants ≈ engine busy time) hold by construction."""
        if not self.enabled or wall_s <= 0 or not rows_by_tenant:
            return
        total = sum(max(0, int(n)) for n in rows_by_tenant.values())
        if total <= 0:
            return
        for tenant, n in rows_by_tenant.items():
            n = max(0, int(n))
            if n == 0:
                continue
            share = wall_s * (n / total)
            t = self._charge(tenant, "device_s", share)
            self._h(t)[3].inc(share)

    def request_seconds(self, tenant: Optional[str], e2e_s: float) -> None:
        if not self.enabled:
            return
        self._h(self.resolve(tenant))[4].observe(e2e_s)

    def request_seconds_many(self, tenant: Optional[str],
                             values: Sequence[float]) -> None:
        """One flush's worth of e2e latencies for one tenant, charged
        under a single child-lock acquisition — the write worker calls
        this once per (tenant, flush) instead of per record."""
        if not self.enabled or not values:
            return
        self._h(self.resolve(tenant))[4].observe_many(values)

    # -- per-tenant SLO views --------------------------------------------------

    def _slo_tracker(self, tenant: str) -> Optional[SloTracker]:
        """Lazily build the per-tenant burn-rate view: explicit
        objectives from ``metering.slo_objectives`` win, then the fleet
        ``serving_slo`` objective; no objective anywhere -> no view."""
        tr = self._slo.get(tenant)
        if tr is not None:
            return tr
        cfg = self._slo_cfg.get(tenant) or self._slo_defaults
        if not isinstance(cfg, dict):
            return None
        try:
            latency_ms = float(cfg["latency_ms"])
        except (KeyError, TypeError, ValueError):
            return None
        if latency_ms <= 0:
            return None
        try:
            window_s = float(cfg.get("window_s", 60.0))
            target = float(cfg.get("target", 0.99))
        except (TypeError, ValueError):
            window_s, target = 60.0, 0.99
        tr = SloTracker(self._registry, latency_ms, window_s=window_s,
                        target=target, tenant=tenant)
        self._slo[tenant] = tr
        return tr

    def slo_observe(self, tenant: Optional[str], e2e_s: float,
                    stages: Optional[Dict] = None) -> None:
        if not self.enabled or not self._slo_possible:
            return
        t = self.resolve(tenant)
        with self._lock:
            tr = self._slo_tracker(t)
        if tr is not None:
            tr.observe(e2e_s, stages)

    # -- journal + health ------------------------------------------------------

    def drain(self) -> List[Dict]:
        """Per-interval usage deltas since the last drain, one record per
        (tenant, model) with any activity — the manager appends them to
        the usage journal on the tracecollect writer contract."""
        with self._lock:
            pending, self._pending = self._pending, {}
            for key, vals in pending.items():
                tot = self._totals.get(key)
                if tot is None:
                    tot = self._totals[key] = dict.fromkeys(_USAGE_FIELDS,
                                                            0.0)
                for f in _USAGE_FIELDS:
                    tot[f] += vals[f]
        now = time.monotonic()
        out = []
        for (tenant, model), vals in sorted(pending.items()):
            if not any(vals.values()):
                continue
            rec = {"ts": now, "tenant": tenant, "model": model}
            for f in _USAGE_FIELDS:
                v = vals[f]
                rec[f] = round(v, 6) if isinstance(v, float) and \
                    v != int(v) else int(v)
            out.append(rec)
        return out

    def snapshot(self) -> Dict:
        """Cumulative per-tenant totals for ``health()["usage"]`` (the
        fleet aggregation sums these across replicas)."""
        with self._lock:
            tenants: Dict[str, Dict] = {}
            # cumulative = drained totals + the not-yet-drained interval
            merged: Dict[Tuple[str, str], List[Dict]] = {}
            for src in (self._totals, self._pending):
                for key, vals in src.items():
                    merged.setdefault(key, []).append(vals)
            for (tenant, model), parts in sorted(merged.items()):
                d = tenants.setdefault(tenant, dict.fromkeys(_USAGE_FIELDS,
                                                             0.0))
                for vals in parts:
                    for f in _USAGE_FIELDS:
                        d[f] += vals[f]
            for d in tenants.values():
                for f in _USAGE_FIELDS:
                    d[f] = round(d[f], 6) if isinstance(d[f], float) and \
                        d[f] != int(d[f]) else int(d[f])
            return {"enabled": self.enabled, "model": self.model,
                    "tenants": tenants,
                    "tenants_tracked": len(self._seen)}
