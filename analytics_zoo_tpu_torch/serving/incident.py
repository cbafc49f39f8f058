"""Incident capture — self-contained forensic bundles.

When something goes wrong — SLO burn crosses the configured threshold, a
replica crashes and the supervisor respawns it, or an operator wants a
snapshot — the question is "what was every process DOING around that
moment", and by the time someone logs in the evidence has rotated away.
``capture()`` snapshots the deployment's entire observable state into
``<pidfile>.incidents/<ts>/``:

- every span spool (traces) and flight-recorder event spool (the
  last-N typed events of every process — ring-bounded, so "last N" is
  what the spool holds),
- every per-replica health snapshot, the autoscaler decision log, the LB
  telemetry snapshot, and the knobs/scale files,
- an ``incident.json`` manifest naming the trigger, the capture wall
  time, and what was captured.

Capture is MANAGER-side file copying of already-drained spools: the
serving hot path is never blocked, paused, or even aware.  Bundles are
bounded (``max_bundles``, oldest evicted) so a flapping trigger cannot
fill the disk.

``load_timeline()`` merges a bundle's spools through the
clock-normalization contract (``tracecollect.merge_spools`` accepts
event spools), so `manager incident --show`
renders recorder events and trace spans on ONE timeline.

Pure stdlib: importable from the manager CLI and the supervisor without
dragging in torch.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.serving import tracecollect

# file patterns bundled from the deployment dir, relative to the pidfile
_CAPTURE_GLOBS = (
    "*.spans.jsonl", "*.spans.jsonl.1",
    "*.events.jsonl", "*.events.jsonl.1",
    # usage metering: the per-tenant usage journal — an incident
    # bundle shows WHO was being served when things went wrong
    "*.usage.jsonl", "*.usage.jsonl.1",
    "*.health.json",
    ".autoscaler.json", ".lb.json", ".knobs.json", ".replicas",
    # rollout: the phase / target / per-replica version
    # assignments at capture time — a rollback bundle must show WHERE the
    # fleet was mid-roll
    ".rollout.state.json",
)

DEFAULT_MAX_BUNDLES = 20


def incidents_dir(pidfile: str) -> str:
    return pidfile + ".incidents"


def capture(pidfile: str, reason: str, meta: Optional[Dict] = None,
            max_bundles: int = DEFAULT_MAX_BUNDLES) -> Optional[str]:
    """Snapshot one incident bundle.  Returns the bundle directory, or
    None when nothing was capturable (no spools/snapshots exist yet).
    Never raises: incident capture must not take the supervisor down."""
    try:
        files: List[str] = []
        for pattern in _CAPTURE_GLOBS:
            files.extend(glob.glob(pidfile + pattern))
        files = sorted(set(f for f in files if os.path.isfile(f)))
        if not files:
            return None
        base = incidents_dir(pidfile)
        # names must be UNIQUE AND MONOTONE even across evictions: a
        # plain per-second name freed by eviction would be reused by the
        # next same-second capture, sort oldest, and get evicted as its
        # own predecessor.  Second AND fraction derive from ONE clock
        # read — two reads could straddle a second boundary and produce
        # "S+1.000..." sorting before "S.999...", the same inversion
        now_ns = time.time_ns()
        ts = time.strftime("%Y%m%d-%H%M%S",
                           time.localtime(now_ns // 1_000_000_000))
        frac = now_ns % 1_000_000_000
        bundle = os.path.join(base, f"{ts}.{frac:09d}")
        n = 1
        while os.path.exists(bundle):       # same-nanosecond paranoia
            bundle = os.path.join(base, f"{ts}.{frac:09d}.{n}")
            n += 1
        os.makedirs(bundle, exist_ok=True)
        prefix = os.path.basename(pidfile)
        captured = []
        for src in files:
            # keep names deployment-relative: <pidfile base name> +
            # suffix, so a bundle is self-describing when copied around
            name = prefix + src[len(pidfile):]
            try:
                shutil.copy2(src, os.path.join(bundle, name))
                captured.append(name)
            except OSError:
                continue
        manifest = {
            "reason": str(reason),
            "wall": time.time(),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pidfile": os.path.abspath(pidfile),
            "files": captured,
        }
        if meta:
            manifest["meta"] = {
                k: v for k, v in meta.items()
                if isinstance(v, (str, int, float, bool, type(None)))}
        with open(os.path.join(bundle, "incident.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        _evict_old(base, max_bundles)
        return bundle
    except Exception:  # noqa: BLE001 — forensics must not crash the
        return None    # supervisor


def _evict_old(base: str, max_bundles: int) -> None:
    try:
        bundles = sorted(
            d for d in glob.glob(os.path.join(base, "*"))
            if os.path.isdir(d))
        for d in bundles[: max(0, len(bundles) - max(1, int(max_bundles)))]:
            shutil.rmtree(d, ignore_errors=True)
    except OSError:
        pass


def list_incidents(pidfile: str) -> List[Dict]:
    """Bundle summaries, oldest first — the `manager incident --list`
    document."""
    out: List[Dict] = []
    for d in sorted(glob.glob(os.path.join(incidents_dir(pidfile), "*"))):
        if not os.path.isdir(d):
            continue
        entry = {"bundle": os.path.basename(d), "path": d}
        try:
            with open(os.path.join(d, "incident.json")) as f:
                man = json.load(f)
            entry.update({k: man.get(k) for k in ("reason", "iso", "wall")})
            entry["files"] = len(man.get("files") or ())
            if man.get("meta"):
                entry["meta"] = man["meta"]
        except (OSError, ValueError):
            entry["reason"] = "unknown (manifest unreadable)"
        out.append(entry)
    return out


def resolve_bundle(pidfile: str, which: Optional[str] = None
                   ) -> Optional[str]:
    """Bundle dir for `--show [which]`: a bundle name, an absolute path,
    or None/"latest" for the newest."""
    if which and os.path.isdir(which):
        return which
    bundles = list_incidents(pidfile)
    if not bundles:
        return None
    if which in (None, "", "latest"):
        return bundles[-1]["path"]
    for b in bundles:
        if b["bundle"] == which:
            return b["path"]
    return None


def load_timeline(bundle: str) -> List[Dict]:
    """Every span + flight-recorder event of a bundle, merged onto one
    wall timeline (``ts_wall``) via the spools' clock contract.  Health
    snapshots in the bundle provide the legacy clock fallback."""
    spools = sorted(
        glob.glob(os.path.join(bundle, "*.spans.jsonl"))
        + glob.glob(os.path.join(bundle, "*.spans.jsonl.1"))
        + glob.glob(os.path.join(bundle, "*.events.jsonl"))
        + glob.glob(os.path.join(bundle, "*.events.jsonl.1")))
    health_docs: Dict[str, Dict] = {}
    for path in glob.glob(os.path.join(bundle, "*.health.json")):
        try:
            with open(path) as f:
                doc = json.load(f)
            rid = str(doc.get("replica_id") or "")
            if rid:
                health_docs[rid] = doc
        except (OSError, ValueError):
            continue
    return tracecollect.merge_spools(spools, health_docs=health_docs)


def render(bundle: str, last: int = 200) -> Dict:
    """The `manager incident --show` document: manifest + the merged
    cross-process timeline (recorder events AND trace spans), trimmed to
    the last ``last`` entries, with per-process and per-kind counts so
    the shape of the incident reads before the detail."""
    manifest: Dict = {}
    try:
        with open(os.path.join(bundle, "incident.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        pass
    merged = load_timeline(bundle)
    t0 = merged[0].get("ts_wall", 0.0) if merged else 0.0
    timeline = []
    for s in merged[-max(1, int(last)):]:
        entry = {
            "t_ms": round((s.get("ts_wall", 0.0) - t0) * 1e3, 3),
            "kind": "event" if s.get("kind") == "event" else "span",
            "what": (s.get("event") if s.get("kind") == "event"
                     else s.get("stage")),
            "process": str(s.get("replica_id") or "unknown"),
        }
        for key in ("uri", "trace_id", "error", "rid", "state",
                    "count", "action", "reason", "replica", "index",
                    "clock_skewed", "stage", "tenant", "priority"):
            if s.get(key) is not None:
                entry[key] = s[key]
        if s.get("dur_s"):                 # zero-width marks stay terse
            entry["dur_s"] = s["dur_s"]
        timeline.append(entry)
    counts: Dict[str, int] = {}
    for s in merged:
        what = str(s.get("event") or s.get("stage"))
        counts[what] = counts.get(what, 0) + 1
    return {
        "bundle": bundle,
        "reason": manifest.get("reason"),
        "captured": manifest.get("iso"),
        "meta": manifest.get("meta"),
        "processes": sorted({str(s.get("replica_id") or "unknown")
                             for s in merged}),
        "entries_total": len(merged),
        "entries_shown": len(timeline),
        "events_by_kind": dict(sorted(counts.items(),
                                      key=lambda kv: -kv[1])),
        "errors": [s.get("error") for s in merged if s.get("error")][-20:],
        "timeline": timeline,
    }
