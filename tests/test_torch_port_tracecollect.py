"""PyTorch port: ``serving/tracecollect.py`` against the JAX package.

Spools written by either package — spans, flight-recorder events, usage
journal deltas and generation checkpoints, with their clock records and
rotation — load in the other, and the readers give equal results:
``merge_spools``, ``traces_in``, ``reconstruct``, ``slowest``,
``chrome_trace`` / ``export_chrome_trace``, ``collect``, ``load_usage``,
``aggregate_usage``, ``load_snapshots``; the path helpers and their
``find_*`` globs agree.  The spans and events come from a port engine's
real traffic (its tracer and flight recorder) and from seeded synthetic
records.
"""

import json
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import tracecollect as jtc
from analytics_zoo_tpu_torch.common.observability import Tracer
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.serving import tracecollect as ttc

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

MODS = {"jax": jtc, "port": ttc}
DIRECTIONS = [("port", "jax"), ("jax", "port")]


def _spans(seed, n_traces=6):
    """Seeded spans across three processes, with parent links, errors,
    tenants and a span with a non-JSON attribute."""
    g = np.random.default_rng(seed)
    tracer = Tracer(replica_id="r0")
    out = []
    for t in range(n_traces):
        tid = f"{seed:02d}{t:02d}" + "a" * 12
        t0 = float(g.uniform(0, 5))
        for k, stage in enumerate(("gateway", "queue_wait", "read",
                                   "predict", "write")):
            dur = float(g.uniform(0.001, 0.05))
            s = tracer.span(stage, t0, t0 + dur, trace_id=tid,
                            uri=f"u{t}", span_id=f"{t:04d}{k:012d}",
                            parent_id=None if k == 0 else
                            f"{t:04d}{k - 1:012d}",
                            error="boom" if (t, k) == (2, 3) else None,
                            attrs={"tenant": "acme"} if k == 3 else None)
            out.append(s)
            t0 += dur + float(g.uniform(0, 0.01))
    out.append({"trace_id": "x" * 16, "stage": "odd", "ts": 1.0,
                "dur_s": 0.5, "blob": object()})
    return out


def _events(seed):
    g = np.random.default_rng(seed)
    return [{"event": str(g.choice(["reclaim", "shed", "brownout"])),
             "ts": float(g.uniform(0, 5)), "replica": "r0",
             "trace_id": f"{seed:02d}00" + "a" * 12, "count": int(i)}
            for i in range(5)]


def _usage(seed):
    g = np.random.default_rng(seed)
    return [{"ts": float(i), "tenant": str(g.choice(["acme", "zeta"])),
             "model": str(g.choice(["m1", "m2"])),
             "records": int(g.integers(0, 5)),
             "tokens": int(g.integers(0, 50)),
             "device_s": round(float(g.uniform(0, 1)), 6),
             "bytes": int(g.integers(0, 999)), "sheds": int(g.integers(0, 2))}
            for i in range(12)]


def _normal(spans):
    """JSON-comparable spans (the writers drop what JSON cannot carry)."""
    return json.loads(json.dumps(spans, default=str))


def test_path_helpers_and_globs_match_jax(tmp_path):
    base = str(tmp_path / "dep.pid")
    for fn in ("spool_path", "events_path", "usage_path", "gensnap_path"):
        assert getattr(ttc, fn)(base) == getattr(jtc, fn)(base)
    for name in (".r0.spans.jsonl", ".r1.spans.jsonl.1", ".lb.spans.jsonl",
                 ".r0.events.jsonl", ".r0.events.jsonl.1",
                 ".r0.usage.jsonl", ".r1.usage.jsonl.1",
                 ".r0.gensnap.jsonl", ".other.txt"):
        (tmp_path / ("dep.pid" + name)).write_text("")
    for fn in ("find_spools", "find_event_spools", "find_usage_spools",
               "find_snapshot_spools"):
        assert getattr(ttc, fn)(base) == getattr(jtc, fn)(base)
        assert getattr(ttc, fn)(base)
    assert ttc.SPOOL_MAX_BYTES == jtc.SPOOL_MAX_BYTES


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_spans_and_events_merge_reconstruct_and_chrome_trace(
        tmp_path, writer, reader):
    """Spools written by one package merge in the other exactly as in the
    writer, through reconstruct, slowest, chrome_trace and collect."""
    w, r = MODS[writer], MODS[reader]
    base = str(tmp_path / "dep.pid")
    paths = []
    for rep in range(2):
        sp = w.spool_path(f"{base}.r{rep}")
        for batch in range(3):
            assert w.append_spans(sp, _spans(10 * rep + batch),
                                  source=f"replica-{rep}") == 31
        ev = w.events_path(f"{base}.r{rep}")
        w.append_events(ev, _events(rep), source=f"replica-{rep}")
        paths += [sp, ev]
    health = {"replica-0": {"clock": {"wall": 1000.0, "monotonic": 1.0}}}
    legacy = str(tmp_path / "legacy.spans.jsonl")
    with open(legacy, "w") as f:
        f.write(json.dumps({"kind": "span", "stage": "old", "ts": 2.0,
                            "dur_s": 0.1, "trace_id": "0000" + "a" * 12,
                            "replica_id": "replica-0"}) + "\n")
        f.write("not json\n")
    paths.append(legacy)
    got = r.merge_spools(paths, health_docs=health)
    want = w.merge_spools(paths, health_docs=health)
    assert got == want and len(got) == 2 * (3 * 31 + 5) + 1
    assert r.traces_in(got) == w.traces_in(want)
    for tid in list(r.traces_in(got))[:4] + ["missing"]:
        assert r.reconstruct(got, tid) == w.reconstruct(want, tid)
    assert r.slowest(got, 5) == w.slowest(want, 5)
    assert r.chrome_trace(got) == w.chrome_trace(want)
    out_r, out_w = str(tmp_path / "r.json"), str(tmp_path / "w.json")
    r.export_chrome_trace(got, out_r)
    w.export_chrome_trace(want, out_w)
    with open(out_r) as a, open(out_w) as b:
        assert json.load(a) == json.load(b)
    for events in (False, True):
        assert r.collect(base, health_docs=health, events=events) == \
            w.collect(base, health_docs=health, events=events)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_usage_journal_load_and_rollup(tmp_path, writer, reader):
    w, r = MODS[writer], MODS[reader]
    path = w.usage_path(str(tmp_path / "dep.pid.r0"))
    w.append_usage(path, _usage(1), source="r0")
    w.append_usage(path, _usage(2))
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "usage", "ts": "bad"}) + "\n")
    assert r.load_usage([path]) == w.load_usage([path])
    recs = r.load_usage([path])
    for by in ("tenant", "model"):
        for since in (None, recs[5]["ts_wall"]):
            assert r.aggregate_usage(recs, by=by, since=since) == \
                w.aggregate_usage(recs, by=by, since=since)
    with pytest.raises(ValueError):
        r.aggregate_usage(recs, by="replica")


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_rotation_and_snapshots_cross_load(tmp_path, writer, reader):
    """A spool past its size cap rotates once to ``.1`` in both; the
    generation checkpoints in it load in the other package, checksums
    equal."""
    w, r = MODS[writer], MODS[reader]
    path = str(tmp_path / "s.gensnap.jsonl")
    snaps = [{"rid": f"r{i}", "epoch": 0, "prompt": [1, 2, i],
              "tokens": list(range(i)), "n": i, "ts": float(i)}
             for i in range(6)]
    for s in snaps:
        s["crc"] = w.snapshot_checksum(s)
    w.append_snapshots(path, snaps[:3], source="a", max_bytes=1)
    w.append_snapshots(path, snaps[3:], source="a", max_bytes=1)
    assert os.path.exists(path + ".1")
    got = r.load_snapshots([path, path + ".1"])
    assert got == w.load_snapshots([path, path + ".1"])
    assert len(got) == 6
    for s in got:
        assert int(s["crc"]) == r.snapshot_checksum(s) == \
            w.snapshot_checksum(s)


def test_port_engine_spans_and_events_round_trip(tmp_path):
    """A port engine's own spans and flight-recorder events, drained and
    spooled by the port, merge and reconstruct identically in the JAX
    package."""
    model = Sequential([tcore.Dense(4, input_shape=(3,), activation="softmax",
                                    name="head")]).init_weights(0)
    im = InferenceModel(device="cpu").do_load_model(model)
    q = tqueues.InProcQueue()
    s = teng.ClusterServing(im, q, teng.ServingParams(batch_size=4,
                                                      replica_id="rt-0"))
    for i in range(6):
        q.xadd({"uri": f"u{i}", "data": [0.1 * i] * 3, "tenant": "acme",
                "trace_id": f"t{i:015d}"})
    q.xadd({"uri": "late", "data": [0.1] * 3, "deadline_ns": 1})
    while s.serve_once():
        pass
    base = str(tmp_path / "dep.pid.r0")
    ttc.append_spans(ttc.spool_path(base), s.tracer.drain_spans(),
                     source=s.replica_id)
    ttc.append_events(ttc.events_path(base),
                      [e for e in s.recorder.events()
                       if e.get("replica") == s.replica_id],
                      source=s.replica_id)
    ttc.append_usage(ttc.usage_path(base), s.drain_usage(),
                     source=s.replica_id)
    s.shutdown()
    got = jtc.collect(str(tmp_path / "dep.pid"), events=True)
    assert got == ttc.collect(str(tmp_path / "dep.pid"), events=True)
    stages = jtc.reconstruct(got, f"t{0:015d}")["stages_ms"]
    assert {"read", "preprocess", "predict", "write"} <= set(stages)
    assert jtc.slowest(got, 3) == ttc.slowest(got, 3)
    usage = jtc.aggregate_usage(jtc.load_usage(
        [ttc.usage_path(base)]))["usage"]
    assert usage["acme"]["records"] == 6
    assert usage["unknown"]["sheds"] == 1
    assert _normal(jtc.chrome_trace(got)) == _normal(ttc.chrome_trace(got))
