"""Fleet-wide trace collection: a copy of the JAX package's
``serving/tracecollect.py``.

Each process in a serving fleet — a front door, every replica (whose
gateway shares its process), the generation scheduler — records spans
into its own in-process ``Tracer`` ring on the MONOTONIC clock.  This
module is the collection half:

- **spools** — a replica's owner periodically calls
  ``Tracer.drain_spans()`` and appends the result here (``append_spans``),
  one jsonl file per process next to its health snapshot:
  ``<pidfile>.rN.spans.jsonl`` per replica.  Each drain batch is preceded
  by a CLOCK record (``{"kind": "clock", "wall": ..., "mono": ...}``)
  captured at the drain, so the spool is self-describing.  Flight-recorder
  events (``append_events``), usage-journal deltas (``append_usage``) and
  generation checkpoints (``append_snapshots``) spool under the same
  rotation and clock contract.
- **merge** — ``merge_spools`` loads every spool, normalizes each span's
  monotonic ``ts`` onto the wall clock through the nearest preceding
  clock record (falling back to a health-doc ``clock`` pair when a
  spool carries none), and returns one flat span list with ``ts_wall``
  (epoch seconds) per span.  Same-host processes share the wall clock,
  so after normalization spans from different processes order correctly
  on one timeline.
- **reconstruction** — ``reconstruct(spans, trace_id)``: the request's
  spans across every process, time-offset from the trace start, with
  parent links, per-process attribution, the e2e wall span, and the
  untracked gaps (queue residency, cross-process handoffs).
  ``slowest(spans, n)`` ranks traces by e2e.  ``chrome_trace(spans)``
  renders the fleet timeline with ONE pid/track per process for Perfetto.

The file formats, the rotation and the checksum are the JAX package's,
bit for bit: a spool written by either package loads in the other.

Pure stdlib.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

# one-generation rotation cap per spool file: a week-long deployment must
# not grow an unbounded span log next to its pidfile
SPOOL_MAX_BYTES = 8 * 1024 * 1024


def spool_path(pidfile: str) -> str:
    """The span spool owned by the process whose pidfile this is (replica
    pidfiles are ``<base>.rN``, so the per-replica spool lands at
    ``<base>.rN.spans.jsonl`` — globbable from the base)."""
    return pidfile + ".spans.jsonl"


def events_path(pidfile: str) -> str:
    """The flight-recorder event spool next to the span spool:
    same per-process ownership, same rotation/clock contract."""
    return pidfile + ".events.jsonl"


def find_spools(pidfile: str) -> List[str]:
    """Every span spool of a deployment: the daemon's own, each
    replica's, and the LB's — anything matching ``<pidfile>*`` with the
    spool suffix (rotated ``.1`` generations included)."""
    out = sorted(set(glob.glob(pidfile + "*.spans.jsonl")
                     + glob.glob(pidfile + "*.spans.jsonl.1")))
    return out


def find_event_spools(pidfile: str) -> List[str]:
    """Every flight-recorder event spool of a deployment —
    replicas, the supervisor's own (autoscaler/LB/incident events), and
    rotated generations."""
    out = sorted(set(glob.glob(pidfile + "*.events.jsonl")
                     + glob.glob(pidfile + "*.events.jsonl.1")))
    return out


def usage_path(pidfile: str) -> str:
    """The usage journal next to the span/event spools: one jsonl
    file of per-interval per-(tenant, model) usage deltas per replica."""
    return pidfile + ".usage.jsonl"


def find_usage_spools(pidfile: str) -> List[str]:
    """Every usage journal of a deployment (rotated generations
    included)."""
    out = sorted(set(glob.glob(pidfile + "*.usage.jsonl")
                     + glob.glob(pidfile + "*.usage.jsonl.1")))
    return out


def gensnap_path(pidfile: str) -> str:
    """The generation-snapshot spool next to the span/event/usage
    spools: one jsonl file of checkpointed decode state per replica, so a
    surviving replica can resume a dead owner's in-flight generations."""
    return pidfile + ".gensnap.jsonl"


def find_snapshot_spools(pidfile: str) -> List[str]:
    """Every generation-snapshot spool of a deployment (rotated
    generations included)."""
    out = sorted(set(glob.glob(pidfile + "*.gensnap.jsonl")
                     + glob.glob(pidfile + "*.gensnap.jsonl.1")))
    return out


def _append_records(path: str, records: List[Dict], kind: str,
                    source: Optional[str], max_bytes: int) -> int:
    """The one spool writer (spans AND events): a clock record
    (wall/monotonic pair captured NOW, i.e. at the drain — the offset the
    merge uses for every record in the batch) followed by the batch.  The
    file rotates once to ``.1`` past ``max_bytes`` so a long-lived
    replica cannot fill the disk."""
    if not records:
        return 0
    try:
        if max_bytes and os.path.exists(path) \
                and os.path.getsize(path) > max_bytes:
            os.replace(path, path + ".1")
    except OSError:
        pass
    clock = {"kind": "clock", "wall": time.time(),
             "mono": time.monotonic()}
    if source is not None:
        clock["source"] = source
    lines = [json.dumps(clock)]
    for s in records:
        rec = {"kind": kind}
        rec.update(s)
        if source is not None:
            rec.setdefault("replica_id", source)
        try:
            lines.append(json.dumps(rec))
        except (TypeError, ValueError):
            # a record smuggling a non-JSON attr must not kill the batch
            lines.append(json.dumps(
                {k: v for k, v in rec.items()
                 if isinstance(v, (str, int, float, bool, type(None)))}))
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")
    return len(records)


def append_spans(path: str, spans: Iterable[Dict],
                 source: Optional[str] = None,
                 max_bytes: int = SPOOL_MAX_BYTES) -> int:
    """Append one ``Tracer.drain_spans()`` batch.  Returns the number of
    spans written."""
    return _append_records(path, list(spans), "span", source, max_bytes)


def append_events(path: str, events: Iterable[Dict],
                  source: Optional[str] = None,
                  max_bytes: int = SPOOL_MAX_BYTES) -> int:
    """Append one ``FlightRecorder.drain_events()`` batch — the
    SAME rotation + drain-time clock contract as span spools, so
    ``merge_spools`` normalizes both onto one wall timeline and `manager
    trace` / `incident_view` agree about when everything happened."""
    return _append_records(path, list(events), "event", source, max_bytes)


def append_snapshots(path: str, records: Iterable[Dict],
                     source: Optional[str] = None,
                     max_bytes: int = SPOOL_MAX_BYTES) -> int:
    """Append one batch of generation checkpoints — the SAME
    rotation + drain-time clock contract as the other spools.  The
    ``gensnap`` kind is unknown to ``merge_spools``, so snapshots never
    pollute trace timelines; they are read back only by
    ``load_snapshots`` on the resume path."""
    return _append_records(path, list(records), "gensnap", source,
                           max_bytes)


def snapshot_checksum(rec: Dict) -> int:
    """Integrity stamp over the fields a resume actually replays: the
    identity, epoch, prompt and generated tokens.  Stored in the record
    at checkpoint time and re-derived at resume time — a truncated or
    corrupted snapshot fails loudly instead of resuming garbage."""
    import zlib
    body = json.dumps([str(rec.get("rid")), int(rec.get("epoch") or 0),
                       [int(t) for t in rec.get("prompt") or []],
                       [int(t) for t in rec.get("tokens") or []]])
    return zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF


def load_snapshots(paths: Iterable[str]) -> List[Dict]:
    """Every generation checkpoint of the given spools, each stamped
    with ``ts_wall`` via the nearest preceding clock record of its file
    (the ``load_usage`` contract; a record with no clock keeps its raw
    ``ts`` and gains ``clock_skewed: true``)."""
    out: List[Dict] = []
    for path in paths:
        offset: Optional[float] = None
        for rec in load_spool(path):
            kind = rec.get("kind")
            if kind == "clock":
                try:
                    offset = float(rec["wall"]) - float(rec["mono"])
                except (KeyError, TypeError, ValueError):
                    pass
                continue
            if kind != "gensnap":
                continue
            rec = {k: v for k, v in rec.items() if k != "kind"}
            try:
                ts = float(rec.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if offset is not None:
                rec["ts_wall"] = ts + offset
            else:
                rec["ts_wall"] = ts
                rec["clock_skewed"] = True
            out.append(rec)
    out.sort(key=lambda r: r.get("ts_wall", 0.0))
    return out


def append_usage(path: str, records: Iterable[Dict],
                 source: Optional[str] = None,
                 max_bytes: int = SPOOL_MAX_BYTES) -> int:
    """Append one ``UsageMeter.drain()`` batch — the SAME
    rotation + drain-time clock contract as span/event spools, so the
    journal's monotonic ``ts`` stamps normalize onto the wall clock the
    same way spans do."""
    return _append_records(path, list(records), "usage", source, max_bytes)


def load_usage(paths: Iterable[str]) -> List[Dict]:
    """Every usage delta of the given journals, each stamped with
    ``ts_wall`` via the nearest preceding clock record of its file
    (mirroring ``merge_spools``; a record with no clock keeps its raw
    ``ts`` and gains ``clock_skewed: true``)."""
    out: List[Dict] = []
    for path in paths:
        offset: Optional[float] = None
        for rec in load_spool(path):
            kind = rec.get("kind")
            if kind == "clock":
                try:
                    offset = float(rec["wall"]) - float(rec["mono"])
                except (KeyError, TypeError, ValueError):
                    pass
                continue
            if kind != "usage":
                continue
            rec = {k: v for k, v in rec.items() if k != "kind"}
            try:
                ts = float(rec.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if offset is not None:
                rec["ts_wall"] = ts + offset
            else:
                rec["ts_wall"] = ts
                rec["clock_skewed"] = True
            out.append(rec)
    out.sort(key=lambda r: r.get("ts_wall", 0.0))
    return out


_USAGE_SUM_FIELDS = ("records", "tokens", "device_s", "bytes", "sheds")


def aggregate_usage(records: Iterable[Dict], by: str = "tenant",
                    since: Optional[float] = None) -> Dict:
    """The ``manager usage`` rollup: sum the journal's per-interval
    deltas grouped ``by`` tenant (default) or model, optionally limited
    to deltas drained after wall time ``since`` (epoch seconds).
    Replaying the journal reproduces the counters, so the rollup is the
    billing-grade view of the same numbers the labelled series carry."""
    if by not in ("tenant", "model"):
        raise ValueError(f"usage rollup: by must be tenant|model, "
                         f"got {by!r}")
    groups: Dict[str, Dict[str, float]] = {}
    n_intervals = 0
    for rec in records:
        if since is not None and rec.get("ts_wall", 0.0) < since:
            continue
        key = str(rec.get(by) or "unknown")
        g = groups.setdefault(key, dict.fromkeys(_USAGE_SUM_FIELDS, 0.0))
        for f in _USAGE_SUM_FIELDS:
            try:
                g[f] += float(rec.get(f, 0) or 0)
            except (TypeError, ValueError):
                pass
        n_intervals += 1
    for g in groups.values():
        for f in _USAGE_SUM_FIELDS:
            g[f] = round(g[f], 6) if g[f] != int(g[f]) else int(g[f])
    return {"by": by, "since": since, "intervals": n_intervals,
            "usage": {k: groups[k] for k in sorted(groups)}}


def load_spool(path: str) -> List[Dict]:
    """Every record (clock + span) of one spool, malformed lines
    skipped."""
    out: List[Dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _doc_clock(doc: Optional[Dict]) -> Optional[Tuple[float, float]]:
    """(wall, mono) out of a health document's ``clock`` block."""
    if not isinstance(doc, dict):
        return None
    c = doc.get("clock")
    try:
        return float(c["wall"]), float(c["monotonic"])
    except (TypeError, KeyError, ValueError):
        return None


def merge_spools(paths: Iterable[str],
                 health_docs: Optional[Dict[str, Dict]] = None
                 ) -> List[Dict]:
    """One flat fleet span list, every span stamped with ``ts_wall``
    (epoch seconds) via the nearest PRECEDING clock record of its spool —
    the drain writes the pair at the same instant as the batch, so the
    offset is exact for that batch even across replica restarts (each
    boot's monotonic epoch differs, which is exactly why a single static
    offset would be wrong).

    ``health_docs`` maps replica_id -> health document; a legacy spool
    with no clock records falls back to its replica's health-doc
    wall/monotonic pair, and a span with no clock at all keeps its raw
    ``ts`` with ``clock_skewed: true`` so downstream consumers can warn
    instead of silently mis-ordering it.

    Flight-recorder EVENT spools merge through the same path:
    an event record keeps ``kind: "event"`` and gets its ``event`` name
    mirrored into ``stage`` so every downstream consumer (reconstruct,
    chrome_trace, incident_view) lays events and spans out on the one
    timeline as zero-duration marks."""
    by_replica_clock: Dict[str, Tuple[float, float]] = {}
    for rid, doc in (health_docs or {}).items():
        pair = _doc_clock(doc)
        if pair is not None:
            by_replica_clock[str(rid)] = pair
    merged: List[Dict] = []
    for path in paths:
        offset: Optional[float] = None
        for rec in load_spool(path):
            if rec.get("kind") == "clock":
                try:
                    offset = float(rec["wall"]) - float(rec["mono"])
                except (KeyError, TypeError, ValueError):
                    pass
                continue
            if rec.get("kind") not in (None, "span", "event"):
                continue
            if rec.get("kind") == "event":
                span = {k: v for k, v in rec.items()}
                span.setdefault("stage", str(span.get("event")))
                span.setdefault("dur_s", 0.0)
            else:
                span = {k: v for k, v in rec.items() if k != "kind"}
            off = offset
            if off is None:
                pair = by_replica_clock.get(
                    str(span.get("replica_id") or ""))
                if pair is not None:
                    off = pair[0] - pair[1]
            try:
                ts = float(span.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if off is not None:
                span["ts_wall"] = ts + off
            else:
                span["ts_wall"] = ts
                span["clock_skewed"] = True
            merged.append(span)
    merged.sort(key=lambda s: s.get("ts_wall", 0.0))
    return merged


# -- reconstruction -------------------------------------------------------------

def _span_source(span: Dict) -> str:
    return str(span.get("replica_id") or "unknown")


def traces_in(spans: Iterable[Dict]) -> Dict[str, List[Dict]]:
    out: Dict[str, List[Dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            out.setdefault(str(tid), []).append(s)
    return out


def reconstruct(spans: Iterable[Dict], trace_id: str) -> Dict:
    """The ``manager trace <id>`` document: one request's timeline across
    every process.  Spans are offset from the trace start (``t_ms``),
    ordered, parent-linked, and the gaps between consecutive spans are
    listed with a ``cross_process`` flag — the handoff costs (queue
    residency, LB->gateway hop) that no single process's ring can see."""
    mine = [s for s in spans if str(s.get("trace_id")) == str(trace_id)]
    if not mine:
        return {"trace_id": trace_id, "spans": 0, "found": False}
    mine.sort(key=lambda s: s.get("ts_wall", 0.0))
    t0 = min(s["ts_wall"] for s in mine)
    t1 = max(s["ts_wall"] + float(s.get("dur_s", 0.0)) for s in mine)
    timeline = []
    for s in mine:
        entry = {"t_ms": round((s["ts_wall"] - t0) * 1e3, 3),
                 "dur_ms": round(float(s.get("dur_s", 0.0)) * 1e3, 3),
                 "stage": s.get("stage"),
                 "process": _span_source(s),
                 "uri": s.get("uri")}
        for key in ("span_id", "parent_id", "error", "tokens",
                    "attempts", "rerouted", "code", "clock_skewed",
                    "tenant", "priority"):
            if s.get(key) is not None:
                entry[key] = s[key]
        timeline.append(entry)
    gaps = []
    for prev, nxt in zip(mine, mine[1:]):
        gap = nxt["ts_wall"] - (prev["ts_wall"]
                                + float(prev.get("dur_s", 0.0)))
        if gap > 0:
            gaps.append({
                "after": prev.get("stage"),
                "before": nxt.get("stage"),
                "gap_ms": round(gap * 1e3, 3),
                "cross_process":
                    _span_source(prev) != _span_source(nxt)})
    stages: Dict[str, float] = {}
    for s in mine:
        st = str(s.get("stage"))
        stages[st] = stages.get(st, 0.0) + float(s.get("dur_s", 0.0)) * 1e3
    return {"trace_id": trace_id,
            "found": True,
            "spans": len(mine),
            "processes": sorted({_span_source(s) for s in mine}),
            "e2e_ms": round((t1 - t0) * 1e3, 3),
            "stages_ms": {k: round(v, 3) for k, v in stages.items()},
            "untracked_ms": round(sum(g["gap_ms"] for g in gaps), 3),
            "errors": [s["error"] for s in mine if s.get("error")],
            "timeline": timeline,
            "gaps": gaps}


def slowest(spans: Iterable[Dict], n: int = 5) -> List[Dict]:
    """Top-N traces by fleet-wide e2e (first span start to last span
    end) — each entry a summary; feed the trace_id back to
    ``reconstruct`` for the full timeline."""
    out = []
    for tid, mine in traces_in(spans).items():
        t0 = min(s.get("ts_wall", 0.0) for s in mine)
        t1 = max(s.get("ts_wall", 0.0) + float(s.get("dur_s", 0.0))
                 for s in mine)
        out.append({
            "trace_id": tid,
            "e2e_ms": round((t1 - t0) * 1e3, 3),
            "spans": len(mine),
            "processes": sorted({_span_source(s) for s in mine}),
            "uri": next((s.get("uri") for s in mine
                         if s.get("uri") is not None), None),
            "error": next((s.get("error") for s in mine
                           if s.get("error")), None)})
    out.sort(key=lambda t: -t["e2e_ms"])
    return out[: max(0, int(n))]


def chrome_trace(spans: Iterable[Dict]) -> Dict:
    """Fleet Chrome trace-event JSON: one pid (track group) per PROCESS —
    lb / replica-0 / replica-1 ... — one tid per stage inside it, so
    Perfetto lays the request out as the cross-process waterfall it is."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict] = []
    meta: List[Dict] = []
    for s in spans:
        src = _span_source(s)
        pid = pids.get(src)
        if pid is None:
            pid = pids[src] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": src}})
        key = (src, str(s.get("stage")))
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == src) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": key[1]}})
        ev = {"name": str(s.get("stage")), "cat": "serving", "ph": "X",
              "ts": round(float(s.get("ts_wall", s.get("ts", 0.0)))
                          * 1e6, 3),
              "dur": round(float(s.get("dur_s", 0.0)) * 1e6, 3),
              "pid": pid, "tid": tid,
              "args": {k: v for k, v in s.items()
                       if k not in ("stage", "ts", "ts_wall", "dur_s")}}
        events.append(ev)
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(spans: Iterable[Dict], path: str) -> str:
    doc = chrome_trace(spans)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def collect(pidfile: str,
            health_docs: Optional[Dict[str, Dict]] = None,
            events: bool = False) -> List[Dict]:
    """The one-call fleet merge the CLI uses: find every spool of the
    deployment, merge, normalize.  ``events=True`` folds the
    flight-recorder event spools into the same timeline — the `manager
    incident --show` / `tools/incident_view.py` view."""
    paths = find_spools(pidfile)
    if events:
        paths = sorted(set(paths) | set(find_event_spools(pidfile)))
    return merge_spools(paths, health_docs=health_docs)
