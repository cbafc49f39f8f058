"""TensorBoard event-file writer/reader in pure Python: a copy of the JAX
package's ``utils/tbwriter.py``, so both packages write the same bytes.

Reference parity: the reference implements its own TensorBoard pipeline in-repo
(zoo/tensorboard/: FileWriter.scala:32-80, EventWriter.scala:32-70, RecordWriter with CRC,
Summary encoding, FileReader.readScalar:80-110).  Same here: hand-encoded Event/Summary
protobufs + TFRecord framing with masked CRC32C — no tensorflow dependency.

Wire format per record: [length:uint64le][masked_crc32c(length):uint32le][payload]
[masked_crc32c(payload):uint32le].  Event proto fields used: wall_time(1,double),
step(2,int64), file_version(3,string), summary(5,message); Summary.value(1) with
tag(1,string), simple_value(2,float), and histo(5,HistogramProto) —
min(1,double), max(2), num(3), sum(4), sum_squares(5), bucket_limit(6,packed
double), bucket(7,packed double) — so observability-registry histograms (e.g.
`fit_step_seconds`) mirror into TensorBoard's HISTOGRAMS tab, with
`read_histograms` as the read-back path.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Tuple

# -- crc32c (software, table-driven) ------------------------------------------

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- minimal protobuf encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode())


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    val = _pb_str(1, tag) + _pb_float(2, float(value))
    summary = _pb_bytes(1, val)
    return (_pb_double(1, wall_time) + _pb_int64(2, step)
            + _pb_bytes(5, summary))


def encode_version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_str(3, "brain.Event:2")


def _pb_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _pb_bytes(field, payload)


def histogram_summary(values, bucket_limits=None) -> Dict:
    """Build a `Summary.histo`-style record from raw samples: min / max /
    num / sum / sum_squares plus per-bucket counts against ``bucket_limits``
    (ascending upper bounds; a final +Inf bound is appended when missing —
    registry histograms pass their own bucket bounds so the TensorBoard
    mirror matches the Prometheus exposition bucket-for-bucket)."""
    vals = [float(v) for v in values]
    if not vals:
        raise ValueError("histogram_summary needs at least one sample")
    if bucket_limits is None:
        lo, hi = min(vals), max(vals)
        if lo == hi:                       # degenerate: one bucket catches all
            bucket_limits = [hi]
        else:
            span = (hi - lo) / 20.0
            bucket_limits = [lo + span * (i + 1) for i in range(20)]
    limits = sorted(float(b) for b in bucket_limits)
    if not limits or limits[-1] != float("inf"):
        limits.append(float("inf"))
    counts = [0] * len(limits)
    for v in vals:
        for i, ub in enumerate(limits):
            if v <= ub:
                counts[i] += 1
                break
    return {"min": min(vals), "max": max(vals), "num": float(len(vals)),
            "sum": sum(vals), "sum_squares": sum(v * v for v in vals),
            "bucket_limit": limits, "bucket": [float(c) for c in counts]}


def encode_histogram_event(tag: str, histo: Dict, step: int,
                           wall_time: float) -> bytes:
    """Event carrying one Summary.Value{tag, histo} (HistogramProto)."""
    hp = (_pb_double(1, histo["min"]) + _pb_double(2, histo["max"])
          + _pb_double(3, histo["num"]) + _pb_double(4, histo["sum"])
          + _pb_double(5, histo["sum_squares"])
          + _pb_packed_doubles(6, histo["bucket_limit"])
          + _pb_packed_doubles(7, histo["bucket"]))
    val = _pb_str(1, tag) + _pb_bytes(5, hp)
    summary = _pb_bytes(1, val)
    return (_pb_double(1, wall_time) + _pb_int64(2, step)
            + _pb_bytes(5, summary))


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class FileWriter:
    """Append scalar summaries to an events file (FileWriter.scala parity)."""

    def __init__(self, logdir: str, flush_secs: float = 5.0):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._last_flush = time.time()
        self.flush_secs = flush_secs
        self._f.write(_record(encode_version_event(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        ev = encode_scalar_event(tag, value, step, time.time())
        self._f.write(_record(ev))
        if time.time() - self._last_flush > self.flush_secs:
            self.flush()

    def add_histogram(self, tag: str, values, step: int,
                      bucket_limits=None):
        """Write raw samples as one histogram summary record: pass
        the observability registry's bucket bounds via ``bucket_limits`` to
        mirror a registry histogram exactly; empty ``values`` is a no-op."""
        values = list(values)
        if not values:
            return
        ev = encode_histogram_event(
            tag, histogram_summary(values, bucket_limits), step, time.time())
        self._f.write(_record(ev))
        if time.time() - self._last_flush > self.flush_secs:
            self.flush()

    def flush(self):
        self._f.flush()
        self._last_flush = time.time()

    def close(self):
        self._f.flush()
        self._f.close()


# -- reader (FileReader.readScalar parity) ------------------------------------

def _decode_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift, out = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _decode_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _decode_varint(buf, i)
        elif wire == 1:
            v = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _decode_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def read_scalars(path_or_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """Read back {tag: [(step, value), ...]} from an events file or logdir."""
    if os.path.isdir(path_or_dir):
        files = sorted(f for f in os.listdir(path_or_dir)
                       if f.startswith("events.out.tfevents"))
        if not files:
            return {}
        path = os.path.join(path_or_dir, files[-1])
    else:
        path = path_or_dir
    out: Dict[str, List[Tuple[int, float]]] = {}
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        (ln,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + ln]
        i += 12 + ln + 4
        step, summary = 0, None
        for field, wire, v in _parse_fields(payload):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                summary = v
        if summary is None:
            continue
        for field, wire, v in _parse_fields(summary):
            if field == 1 and wire == 2:
                tag, value = None, None
                for f2, w2, v2 in _parse_fields(v):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif f2 == 2 and w2 == 5:
                        (value,) = struct.unpack("<f", v2)
                if tag is not None and value is not None:
                    out.setdefault(tag, []).append((step, value))
    return out


def _resolve_events_file(path_or_dir: str) -> str:
    if os.path.isdir(path_or_dir):
        files = sorted(f for f in os.listdir(path_or_dir)
                       if f.startswith("events.out.tfevents"))
        if not files:
            return ""
        return os.path.join(path_or_dir, files[-1])
    return path_or_dir


def _unpack_doubles(buf: bytes) -> List[float]:
    return [struct.unpack("<d", buf[i:i + 8])[0]
            for i in range(0, len(buf) - 7, 8)]


def read_histograms(path_or_dir: str) -> Dict[str, List[Tuple[int, Dict]]]:
    """Read back {tag: [(step, histo), ...]} where histo carries min / max /
    num / sum / sum_squares / bucket_limit / bucket — the read-back check
    for `FileWriter.add_histogram` (registry-histogram mirroring)."""
    path = _resolve_events_file(path_or_dir)
    if not path:
        return {}
    out: Dict[str, List[Tuple[int, Dict]]] = {}
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        (ln,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + ln]
        i += 12 + ln + 4
        step, summary = 0, None
        for field, wire, v in _parse_fields(payload):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                summary = v
        if summary is None:
            continue
        for field, wire, v in _parse_fields(summary):
            if field != 1 or wire != 2:
                continue
            tag, histo_buf = None, None
            for f2, w2, v2 in _parse_fields(v):
                if f2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif f2 == 5 and w2 == 2:
                    histo_buf = v2
            if tag is None or histo_buf is None:
                continue
            histo: Dict = {"bucket_limit": [], "bucket": []}
            names = {1: "min", 2: "max", 3: "num", 4: "sum",
                     5: "sum_squares"}
            for f3, w3, v3 in _parse_fields(histo_buf):
                if f3 in names and w3 == 1:
                    (histo[names[f3]],) = struct.unpack("<d", v3)
                elif f3 == 6 and w3 == 2:        # packed repeated double
                    histo["bucket_limit"] = _unpack_doubles(v3)
                elif f3 == 7 and w3 == 2:
                    histo["bucket"] = _unpack_doubles(v3)
                elif f3 == 6 and w3 == 1:        # unpacked fallback
                    histo["bucket_limit"].append(
                        struct.unpack("<d", v3)[0])
                elif f3 == 7 and w3 == 1:
                    histo["bucket"].append(struct.unpack("<d", v3)[0])
            out.setdefault(tag, []).append((step, histo))
    return out
