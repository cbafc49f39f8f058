"""Generation-snapshot spools: the snapshot half of the JAX package's
``serving/tracecollect.py``.

A serving replica that checkpoints its in-flight generations appends each
batch of snapshots to a jsonl spool next to its pidfile
(``<pidfile>.gensnap.jsonl``).  Each batch is preceded by a CLOCK record
(``{"kind": "clock", "wall": ..., "mono": ...}``) captured at the write, so
the spool is self-describing: ``load_snapshots`` stamps every record with
its wall time.  A spool rotates once to ``.1`` past ``SPOOL_MAX_BYTES``.

The file format, the rotation and the integrity checksum are the JAX
package's, bit for bit: a spool written by either package loads in the
other.  The span, event and usage spools (the fleet's trace collection)
come with the fleet control plane.

Pure stdlib.
"""

from __future__ import annotations

import glob
import json
import os
import time
import zlib
from typing import Dict, Iterable, List, Optional

# one-generation rotation cap per spool file: a week-long deployment must
# not grow an unbounded log next to its pidfile
SPOOL_MAX_BYTES = 8 * 1024 * 1024


def gensnap_path(pidfile: str) -> str:
    """The generation-snapshot spool of the process whose pidfile this is:
    one jsonl file of checkpointed decode state per replica, so a
    surviving replica can resume a dead owner's in-flight generations."""
    return pidfile + ".gensnap.jsonl"


def find_snapshot_spools(pidfile: str) -> List[str]:
    """Every generation-snapshot spool of a deployment (rotated generations
    included)."""
    return sorted(set(glob.glob(pidfile + "*.gensnap.jsonl")
                      + glob.glob(pidfile + "*.gensnap.jsonl.1")))


def _append_records(path: str, records: List[Dict], kind: str,
                    source: Optional[str], max_bytes: int) -> int:
    """The one spool writer: a clock record (wall/monotonic pair captured
    NOW, the offset a reader uses for every record in the batch) followed
    by the batch.  The file rotates once to ``.1`` past ``max_bytes`` so a
    long-lived replica cannot fill the disk."""
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


def append_snapshots(path: str, records: Iterable[Dict],
                     source: Optional[str] = None,
                     max_bytes: int = SPOOL_MAX_BYTES) -> int:
    """Append one batch of generation checkpoints.  Returns the number of
    records written."""
    return _append_records(path, list(records), "gensnap", source,
                           max_bytes)


def snapshot_checksum(rec: Dict) -> int:
    """Integrity stamp over the fields a resume replays: the identity,
    epoch, prompt and generated tokens.  Stored in the record at
    checkpoint time and re-derived at resume time — a truncated or
    corrupted snapshot fails loudly instead of resuming garbage."""
    body = json.dumps([str(rec.get("rid")), int(rec.get("epoch") or 0),
                       [int(t) for t in rec.get("prompt") or []],
                       [int(t) for t in rec.get("tokens") or []]])
    return zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF


def load_spool(path: str) -> List[Dict]:
    """Every record (clock + payload) of one spool, malformed lines
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


def load_snapshots(paths: Iterable[str]) -> List[Dict]:
    """Every generation checkpoint of the given spools, each stamped with
    ``ts_wall`` through the nearest preceding clock record of its file (a
    record with no clock keeps its raw ``ts`` and gains
    ``clock_skewed: true``), oldest first."""
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
