"""Cross-replica metrics aggregation.

One replica's registry answers "how is THIS engine doing"; an elastic
deployment needs the FLEET view — the same numbers the autoscaler feeds
its policy and the operator asks ``manager metrics --all-replicas`` for.
This module is that aggregation, shared by both consumers:

- ``replica_docs(pidfile, ...)`` — one health document per replica slot:
  scraped over HTTP from the replica's probe port (``http_port + i``, the
  exact document ``/healthz`` serves) with the ``<pidfile>.r<i>.health.json``
  snapshot as the fallback when the port is unreachable (gateway off, or
  the replica just died — the snapshot then reports a stale heartbeat
  instead of vanishing silently).
- ``aggregate_health(docs)`` — the fleet snapshot: cumulative counters
  SUMMED across replicas, queue depth/pending taken as the MAX (every
  replica reports the same shared queue — summing would multiply it by N),
  per-replica heartbeat ages, and the conservative (max) cross-replica
  stage p99s.
- ``fleet_metrics(docs)`` — the ``manager metrics --all-replicas`` JSON
  document: the per-engine metrics shape, fleet-wide, with a
  per-replica breakdown.
- ``scrape_prometheus(...)`` / ``merge_prometheus(texts)`` — fleet-wide
  Prometheus exposition: per-series SUM across replicas (counters and
  histogram ``_bucket``/``_sum``/``_count`` series add correctly), with
  the shared-queue gauges (``serving_queue_depth``,
  ``serving_dead_letters``) merged as MAX for the same reason as above.

Pure stdlib: importable from the manager CLI and the autoscaler without
dragging in torch.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

# gauges that report a SHARED resource (the one queue every replica reads)
# or a RATIO (the SLO burn rate — summing per-replica burn rates
# would overstate the fleet's budget spend; the max is the conservative
# fleet verdict): merged as MAX, never summed
SHARED_MAX_METRICS = frozenset({"serving_queue_depth",
                                "serving_dead_letters",
                                "serving_slo_burn_rate",
                                "serving_slo_latency_objective_ms",
                                # a ladder STAGE is an ordinal,
                                # not a quantity — the fleet's brownout
                                # verdict is its worst replica's
                                "serving_brownout_stage"})


def read_scale(pidfile: str, default: int = 0) -> int:
    """The supervisor's desired replica count from ``<pidfile>.replicas``
    (what ``manager scale N`` writes) — the one reader every consumer
    (fleet scrape, LB membership, ManagerFleet, the metrics CLI) shares."""
    try:
        with open(pidfile + ".replicas") as f:
            return max(0, int(f.read().strip()))
    except (OSError, ValueError):
        return default


def _http_json(url: str, timeout: float = 2.0) -> Optional[Dict]:
    """GET a JSON document; non-2xx responses that still carry a JSON body
    (``/healthz`` answers 503 with the full health doc while draining or
    failed) are parsed too."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except (ValueError, OSError):
            return None
    except Exception:  # noqa: BLE001 — unreachable / refused / timeout
        return None


def replica_docs(pidfile: str, http_host: str = "127.0.0.1",
                 http_port: Optional[int] = None,
                 count: Optional[int] = None) -> Dict[int, Dict]:
    """Health documents per replica slot.  ``count`` bounds the slots
    probed (defaults to the supervisor's ``<pidfile>.replicas`` target);
    slots with neither a reachable probe port nor a health snapshot are
    simply absent from the result.  Snapshot-sourced docs get their
    ``heartbeat_age_s`` aged by the snapshot's own staleness, so a replica
    that died between snapshots reads as stale, not frozen-fresh."""
    if count is None:
        count = read_scale(pidfile)
    docs: Dict[int, Dict] = {}
    for i in range(max(0, int(count))):
        doc = None
        if http_port:
            doc = _http_json(f"http://{http_host}:{http_port + i}/healthz")
        if doc is None:
            try:
                with open(f"{pidfile}.r{i}.health.json") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                doc = None
            if isinstance(doc, dict):
                staleness = max(0.0, time.time() - float(doc.get("ts", 0)))
                doc["heartbeat_age_s"] = max(
                    float(doc.get("heartbeat_age_s", 0.0)), staleness)
                doc["snapshot_stale_s"] = round(staleness, 3)
        if isinstance(doc, dict):
            docs[i] = doc
    return docs


def _stage_p99(doc: Dict, stage: str) -> Optional[float]:
    try:
        v = doc["stages"][stage]["p99_ms"]
        return None if v is None else float(v)
    except (KeyError, TypeError, ValueError):
        return None


def _opt_max(values: Iterable[Optional[float]]) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return max(vals) if vals else None


def aggregate_health(docs: Dict[int, Dict]) -> Dict:
    """The fleet snapshot the autoscaler consumes (see module docstring
    for the sum-vs-max rules)."""
    served = shed = quarantined = reclaimed = duplicates = restarts = 0
    depth = pending = dead_letters = 0
    hb: Dict[str, float] = {}
    knobs: Optional[Dict] = None
    alive = 0
    warming = 0                      # replicas still compiling
    cold_start: Optional[float] = None   # slowest measured cold start
    slo_burn: Optional[float] = None     # worst replica burn rate
    slo_violations = 0
    # overload armor: admission tallies SUM (each replica's gate
    # is its own stream of verdicts); the brownout stage is an ordinal —
    # the fleet is as browned-out as its WORST replica
    admitted = rejected = 0
    rejected_by: Dict[str, int] = {}
    admission_seen = False
    brownout_stage: Optional[int] = None
    # resource accounting: HBM components SUM across replicas
    # (each replica pins its own copy), per-process stats sum with a max
    # alongside RSS so one bloated replica stands out
    res = {"weights_bytes": 0, "kv_state_bytes": 0, "executables": 0,
           "executable_code_bytes": 0, "total_bytes": 0}
    res_seen = False
    proc = {"rss_bytes": 0, "rss_max_bytes": 0, "cpu_seconds": 0.0,
            "open_fds": 0, "threads": 0}
    proc_seen = False
    # model-version mix: during a rollout the fleet is
    # intentionally heterogeneous — surface version -> replica count so
    # `manager status` shows the canary/rolling split at a glance
    versions: Dict[str, int] = {}
    # paged KV pool: block capacity/occupancy and prefix-cache
    # traffic SUM across replicas (each owns its own pool); exhaustion
    # stalls sum so an under-provisioned fleet shows one number
    gen_pool = {"blocks": 0, "free_blocks": 0, "used_blocks": 0,
                "prefix_hits": 0, "prefix_misses": 0,
                "prefix_evictions": 0, "exhausted": 0,
                "active_slots": 0}
    gen_pool_seen = False
    # generation continuity: resume traffic SUMS across replicas
    # (a crash on one replica surfaces as a resume on another — fleet
    # totals are the only view where both sides of the handoff meet)
    continuity = {"resumed": 0, "resume_failed": 0, "checkpoints": 0,
                  "snapshot_bytes": 0}
    continuity_seen = False
    # usage attribution: per-tenant cumulative totals SUM across
    # replicas (each meters its own traffic; the LB spreads one tenant
    # over many replicas)
    usage_tenants: Dict[str, Dict[str, float]] = {}
    usage_seen = False
    for i, doc in sorted(docs.items()):
        served += int(doc.get("total_records", 0))
        shed += int(doc.get("shed", 0))
        quarantined += int(doc.get("dead_lettered", 0))
        reclaimed += int(doc.get("reclaimed", 0))
        duplicates += int(doc.get("duplicates", 0))
        restarts += sum(w.get("restart_count", 0)
                        for w in (doc.get("workers") or {}).values())
        if doc.get("running"):
            alive += 1
        q = doc.get("queue") or {}
        depth = max(depth, int(q.get("depth", 0) or 0))
        pending = max(pending, int(q.get("pending", 0) or 0))
        dead_letters = max(dead_letters, int(q.get("dead_letters", 0) or 0))
        rid = doc.get("replica_id") or f"replica-{i}"
        try:
            hb[rid] = float(doc.get("heartbeat_age_s", float("inf")))
        except (TypeError, ValueError):
            hb[rid] = float("inf")
        if knobs is None and isinstance(doc.get("knobs"), dict):
            knobs = doc["knobs"]
        mv = doc.get("model_version")
        if mv is not None:
            versions[str(mv)] = versions.get(str(mv), 0) + 1
        w = doc.get("warmup") or {}
        if w.get("state") in ("pending", "warming"):
            warming += 1
        cs = doc.get("cold_start_s")
        if isinstance(cs, (int, float)):
            cold_start = cs if cold_start is None else max(cold_start, cs)
        slo = doc.get("slo") or {}
        br = slo.get("burn_rate")
        if isinstance(br, (int, float)):
            slo_burn = br if slo_burn is None else max(slo_burn, br)
        wv = slo.get("window_violations")
        if isinstance(wv, int):
            slo_violations += wv
        adm = doc.get("admission") or {}
        if isinstance(adm.get("admitted"), int):
            admission_seen = True
            admitted += int(adm.get("admitted") or 0)
            rejected += int(adm.get("rejected") or 0)
            for reason, n in (adm.get("rejected_by_reason") or {}).items():
                if isinstance(n, int):
                    rejected_by[reason] = rejected_by.get(reason, 0) + n
        bo = doc.get("brownout") or {}
        if isinstance(bo.get("stage"), int):
            brownout_stage = bo["stage"] if brownout_stage is None \
                else max(brownout_stage, bo["stage"])
        r = doc.get("resources") or {}
        if isinstance(r.get("weights_bytes"), (int, float)):
            res_seen = True
            res["weights_bytes"] += int(r.get("weights_bytes") or 0)
            res["kv_state_bytes"] += int(r.get("kv_state_bytes") or 0)
            res["total_bytes"] += int(r.get("total_bytes") or 0)
            exes = r.get("executables") or {}
            res["executables"] += int(exes.get("count") or 0)
            res["executable_code_bytes"] += int(exes.get("code_bytes")
                                                or 0)
        g = doc.get("generation") or {}
        gp = g.get("pool") or {}
        if isinstance(gp.get("blocks"), int):
            gen_pool_seen = True
            for k in ("blocks", "free_blocks", "used_blocks",
                      "prefix_hits", "prefix_misses", "prefix_evictions",
                      "exhausted"):
                gen_pool[k] += int(gp.get(k) or 0)
            gen_pool["active_slots"] += int(g.get("active_slots") or 0)
        if isinstance(g.get("resumed"), int):
            continuity_seen = True
            for k in continuity:
                continuity[k] += int(g.get(k) or 0)
        u = doc.get("usage") or {}
        if isinstance(u.get("tenants"), dict):
            usage_seen = True
            for tenant, vals in u["tenants"].items():
                dst = usage_tenants.setdefault(str(tenant), {})
                if isinstance(vals, dict):
                    for k, v in vals.items():
                        if isinstance(v, (int, float)):
                            dst[k] = dst.get(k, 0) + v
        pr = doc.get("process") or {}
        if isinstance(pr.get("rss_bytes"), (int, float)):
            proc_seen = True
            proc["rss_bytes"] += int(pr.get("rss_bytes") or 0)
            proc["rss_max_bytes"] = max(proc["rss_max_bytes"],
                                        int(pr.get("rss_bytes") or 0))
            proc["cpu_seconds"] += float(pr.get("cpu_seconds") or 0.0)
            proc["open_fds"] += int(pr.get("open_fds") or 0)
            proc["threads"] += int(pr.get("threads") or 0)
    return {"replicas_total": len(docs),
            "replicas_alive": alive,
            "replicas_warming": warming,
            "cold_start_s": cold_start,
            "served": served, "shed": shed, "quarantined": quarantined,
            "reclaimed": reclaimed, "duplicates": duplicates,
            "restarts": restarts,
            "queue_depth": depth, "pending": pending,
            "dead_letters": dead_letters,
            "heartbeat_ages": hb,
            "e2e_p99_ms": _opt_max(_stage_p99(d, "e2e")
                                   for d in docs.values()),
            "preprocess_p99_ms": _opt_max(_stage_p99(d, "preprocess")
                                          for d in docs.values()),
            "predict_p99_ms": _opt_max(_stage_p99(d, "predict")
                                       for d in docs.values()),
            # SLO attribution: worst replica burn rate + windowed
            # violation count — the signal a per-model autoscaler
            # (ROADMAP item 1) will judge overload on
            "slo_burn_rate": slo_burn,
            "slo_window_violations": slo_violations,
            # overload armor: summed gate verdicts + the worst
            # replica's brownout stage (None = no replica reports them)
            "admitted": admitted if admission_seen else None,
            "rejected": rejected if admission_seen else None,
            "rejected_by_reason": rejected_by if admission_seen else None,
            "brownout_stage": brownout_stage,
            # resource accounting: fleet HBM decomposition +
            # summed per-process resources (None when no replica reports
            # them yet — old snapshots mid-rolling-upgrade)
            # version mix: None while every replica is
            # unversioned (pre-registry deployments)
            "versions": versions or None,
            "resources": res if res_seen else None,
            # paged KV: summed pool capacity/occupancy + prefix
            # traffic (None when no replica runs a paged batcher)
            "kv_pool": dict(gen_pool, occupancy=round(
                gen_pool["used_blocks"] / max(1, gen_pool["blocks"]), 4))
            if gen_pool_seen else None,
            # generation continuity: summed resume/checkpoint
            # traffic (None when no replica runs a generation plane)
            "continuity": dict(continuity) if continuity_seen else None,
            "process": dict(proc, cpu_seconds=round(proc["cpu_seconds"],
                                                    3))
            if proc_seen else None,
            # usage attribution: summed per-tenant totals (None
            # when no replica reports a usage block — pre-PR-19 snapshots)
            "usage": {t: {k: (round(v, 6) if isinstance(v, float)
                              and v != int(v) else int(v))
                          for k, v in sorted(vals.items())}
                      for t, vals in sorted(usage_tenants.items())}
            if usage_seen else None,
            "knobs": knobs}


def fleet_metrics(docs: Dict[int, Dict], lb: Optional[Dict] = None) -> Dict:
    """``manager metrics --all-replicas`` JSON: the familiar per-engine
    metrics document shape, fleet-wide, plus a per-replica breakdown so an
    imbalanced fleet is visible at a glance.  ``lb``: the
    front door's telemetry snapshot (``lb_snapshot``) — its
    requests/retries/member gauges join the document instead of staying
    invisible in the supervisor process."""
    agg = aggregate_health(docs)
    per_replica = {}
    for i, doc in sorted(docs.items()):
        e2e = (doc.get("stages") or {}).get("e2e") or {}
        member = {
            "served": doc.get("total_records", 0),
            "shed": doc.get("shed", 0),
            "quarantined": doc.get("dead_lettered", 0),
            "reclaimed": doc.get("reclaimed", 0),
            "running": bool(doc.get("running")),
            "heartbeat_age_s": doc.get("heartbeat_age_s"),
            "p99_ms": e2e.get("p99_ms")}
        if doc.get("model_version") is not None:
            member["model_version"] = doc["model_version"]
        # warm-up visibility: a replica that exists but is not
        # taking traffic yet shows `warming (k/n)` here, so `manager
        # metrics --all-replicas` explains the gap between desired and
        # serving capacity
        w = doc.get("warmup") or {}
        if w.get("state") and w["state"] != "off":
            member["warmup"] = {k: w.get(k) for k in
                                ("state", "compiled", "total", "seconds")}
        if doc.get("cold_start_s") is not None:
            member["cold_start_s"] = doc["cold_start_s"]
        pr = doc.get("process") or {}
        if isinstance(pr.get("rss_bytes"), (int, float)):
            member["rss_bytes"] = int(pr["rss_bytes"])
        r = doc.get("resources") or {}
        if isinstance(r.get("total_bytes"), (int, float)):
            member["hbm_bytes"] = int(r["total_bytes"])
        per_replica[doc.get("replica_id") or f"replica-{i}"] = member
    out = {"replicas": {"total": agg["replicas_total"],
                        "alive": agg["replicas_alive"],
                        "warming": agg["replicas_warming"]},
            "cold_start_s": agg["cold_start_s"],
            "served": agg["served"],
            "quarantined": agg["quarantined"],
            "shed": agg["shed"],
            "reclaimed": agg["reclaimed"],
            "duplicates": agg["duplicates"],
            "restarts": agg["restarts"],
            "queue_depth": agg["queue_depth"],
            "pending": agg["pending"],
            "dead_letters": agg["dead_letters"],
            "latency_ms": {"p50": _opt_max(
                (d.get("stages", {}).get("e2e") or {}).get("p50_ms")
                for d in docs.values()),
                "p99": agg["e2e_p99_ms"]},
           "per_replica": per_replica}
    if agg.get("slo_burn_rate") is not None:
        out["slo"] = {"burn_rate": agg["slo_burn_rate"],
                      "window_violations": agg["slo_window_violations"]}
    if agg.get("admitted") is not None:
        out["admission"] = {
            "admitted": agg["admitted"],
            "rejected": agg["rejected"],
            "rejected_by_reason": agg["rejected_by_reason"]}
    if agg.get("brownout_stage") is not None:
        out["brownout_stage"] = agg["brownout_stage"]
    # version mix: which model versions the fleet is serving —
    # heterogeneous exactly while a rollout is in flight
    if agg.get("versions"):
        out["versions"] = agg["versions"]
    # resource accounting: the fleet HBM decomposition + summed
    # per-process stats ride the metrics doc next to the SLO block
    if agg.get("resources") is not None:
        out["resources"] = agg["resources"]
    if agg.get("process") is not None:
        out["process"] = agg["process"]
    # usage attribution: the fleet-summed per-tenant block —
    # `manager metrics --all-replicas` shows who used what
    if agg.get("usage") is not None:
        out["usage"] = agg["usage"]
    summary = lb_summary(lb)
    if summary is not None:
        out["lb"] = summary
    return out


# -- Prometheus exposition merge ----------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$")


def scrape_prometheus(count: int, http_host: str = "127.0.0.1",
                      http_port: Optional[int] = None,
                      timeout: float = 2.0) -> List[str]:
    """One Prometheus text exposition per reachable replica probe port."""
    texts: List[str] = []
    if not http_port:
        return texts
    for i in range(max(0, int(count))):
        url = f"http://{http_host}:{http_port + i}/metrics?format=prom"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                texts.append(resp.read().decode())
        except Exception:  # noqa: BLE001 — dead slot: skip
            continue
    return texts


def merge_prometheus(texts: Iterable[str],
                     max_names: frozenset = SHARED_MAX_METRICS) -> str:
    """Merge N replicas' text expositions into one fleet exposition:
    identical series (same name + label set) SUM — counters add, histogram
    ``_bucket``/``_sum``/``_count`` series add into a valid fleet
    histogram — except the shared-resource gauges in ``max_names``, which
    take the MAX (every replica reports the same queue).  Series unique to
    one replica (e.g. per-replica heartbeat gauges) pass through.  HELP /
    TYPE lines keep their first-seen text; series keep first-seen order."""
    help_type: Dict[str, List[str]] = {}
    family_order: List[str] = []
    series: Dict[Tuple[str, str], float] = {}
    series_order: Dict[str, List[Tuple[str, str]]] = {}
    series_family: Dict[Tuple[str, str], str] = {}

    def family_of(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix) and \
                    sample_name[: -len(suffix)] in help_type:
                return sample_name[: -len(suffix)]
        return sample_name

    for text in texts:
        for line in (text or "").splitlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    name = parts[2]
                    if name not in help_type:
                        help_type[name] = []
                        family_order.append(name)
                        series_order[name] = []
                    if len(help_type[name]) < 2:
                        # first replica's HELP+TYPE pair wins
                        prefix = f"# {parts[1]} {name}"
                        if not any(h.startswith(prefix)
                                   for h in help_type[name]):
                            help_type[name].append(line)
                continue
            m = _SAMPLE_RE.match(line)
            if not m:
                continue
            name, labels, raw = m.group(1), m.group(2) or "", m.group(3)
            try:
                value = float(raw)
            except ValueError:
                continue
            fam = family_of(name)
            if fam not in series_order:
                family_order.append(fam)
                series_order[fam] = []
                help_type.setdefault(fam, [])
            key = (name, labels)
            if key not in series:
                series[key] = value
                series_order[fam].append(key)
                series_family[key] = fam
            elif value == value:           # skip NaN contributions
                if series[key] != series[key]:
                    series[key] = value
                elif fam in max_names:
                    series[key] = max(series[key], value)
                else:
                    series[key] += value
    out: List[str] = []
    for fam in family_order:
        out.extend(help_type.get(fam, []))
        for name, labels in series_order.get(fam, []):
            v = series[(name, labels)]
            if v != v:
                sval = "NaN"
            elif v in (float("inf"), float("-inf")):
                sval = "+Inf" if v > 0 else "-Inf"
            elif float(v) == int(v):
                sval = str(int(v))
            else:
                sval = repr(float(v))
            out.append(f"{name}{labels} {sval}")
    return "\n".join(out) + "\n"


def lb_snapshot(pidfile: str) -> Optional[Dict]:
    """The LB telemetry snapshot the supervisor persists each pass
    (``<pidfile>.lb.json``: registry snapshot + Prometheus exposition) —
    how ``manager metrics --all-replicas`` sees the front door without
    reaching into the supervisor process."""
    try:
        with open(pidfile + ".lb.json") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def lb_summary(snap: Optional[Dict]) -> Optional[Dict]:
    """Compact LB block for the fleet metrics document:
    requests by endpoint/code, re-routes, member rotation state — the
    series that were invisible to the fleet doc while they lived only in
    the supervisor's in-process registry."""
    if not isinstance(snap, dict):
        return None
    reg = snap.get("snapshot") or {}

    def values(name):
        return (reg.get(name) or {}).get("values") or []

    requests: Dict[str, float] = {}
    total = 0.0
    for v in values("lb_requests_total"):
        labels = v.get("labels") or {}
        key = f"{labels.get('endpoint', '?')}:{labels.get('code', '?')}"
        val = float(v.get("value", 0) or 0)
        requests[key] = requests.get(key, 0.0) + val
        total += val
    retries = sum(float(v.get("value", 0) or 0)
                  for v in values("lb_retries_total"))

    def gauge(name):
        vals = values(name)
        return float(vals[0].get("value", 0) or 0) if vals else None

    return {"url": snap.get("url"),
            "ts": snap.get("ts"),
            "requests_total": total,
            "requests": requests,
            "retries_total": retries,
            "members_total": gauge("lb_members_total"),
            "members_ready": gauge("lb_members_ready")}


def autoscaler_snapshot(pidfile: str) -> Optional[Dict]:
    """The controller snapshot the supervisor persists each tick
    (``<pidfile>.autoscaler.json``) — decision counters, target gauges and
    the decision log — so ``manager metrics`` can surface controller
    activity without reaching into the supervisor process."""
    try:
        with open(pidfile + ".autoscaler.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
