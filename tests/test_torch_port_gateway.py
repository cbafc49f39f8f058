"""PyTorch port: the HTTP front door against the JAX package on the CPU.

The same HTTP requests go to a JAX engine and a port engine over the same
tiny model (weights loaded with ``load_jax_params``), each on its own
``127.0.0.1`` ephemeral port, and the replies are compared: status codes,
body keys (bodies where they are deterministic), ``X-Replica-Id`` and
``Retry-After``:

- the binary-frame and JSON round trips, malformed bodies (400), the
  not-ready miss (404);
- the queue's 429 and the drain's 503, traversal uris, shm records and
  untyped fields (400), the long-poll cap (503 past it);
- ``gateway=False`` leaving the probes only, the per-endpoint histograms,
  ``traceparent`` continuation;
- the tenant gate's 429 with its computed ``Retry-After``;
- ``/healthz``, ``/readyz`` and ``/metrics`` documents (key sets);
- ``/debug/profile``: gated by ``profiling`` as in JAX; in the port one
  ``torch.profiler`` trace is written, a second request while it runs
  answers 409, and so does a request while another profiler session of
  the process holds ``ops/_impl.PROFILER_LOCK``.

Generation over the gateway (port only): binary frames from two tenants,
tokens equal to a direct run of the batcher, every partial a prefix.
"""

import itertools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.models import Sequential as JaxSeq
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import http as jhttp
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu.serving import wire as jwire
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving import http as thttp
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.serving import wire as twire
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DIM, NCLS = 3, 4
PKGS = ("jax", "port")
ENG = {"jax": jeng, "port": teng}
HTTP = {"jax": jhttp, "port": thttp}
QUEUES = {"jax": jqueues, "port": tqueues}
WIRE = {"jax": jwire, "port": twire}
# replica ids unique in the process: the flight recorder is the
# process's, and tests read their engine's events by replica id
_IDS = itertools.count()


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


@pytest.fixture(scope="module")
def dense():
    jm = JaxSeq([jcore.Dense(NCLS, input_shape=(DIM,), activation="softmax",
                             name="head")])
    params, state = jm.init(jax.random.PRNGKey(0), (DIM,))
    params = jax.tree.map(np.asarray, params)
    tm = Sequential([tcore.Dense(NCLS, input_shape=(DIM,),
                                 activation="softmax", name="head")])
    load_jax_params(tm, params)
    return {"jax": JaxIM().do_load_model(jm, params, state),
            "port": InferenceModel(device="cpu").do_load_model(tm)}


def _engine(pkg, models, queue=None, **params):
    p = dict(batch_size=4, poll_timeout_s=0.02, write_backoff_s=0.01,
             worker_backoff_s=0.01, replica_id=f"gw-{pkg}-{next(_IDS)}",
             http_port=0)
    p.update(params)
    queue = queue if queue is not None else QUEUES[pkg].InProcQueue()
    return ENG[pkg].ClusterServing(models[pkg], queue,
                                   ENG[pkg].ServingParams(**p))


def _call(url, data=None, headers=None, method=None):
    """(status, headers, body) of one request; error statuses are replies
    too."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_json(url, rec, path="/v1/enqueue", **headers):
    return _call(url + path, json.dumps(rec).encode(),
                 dict({"Content-Type": "application/json"}, **headers))


def _post_frame(url, frame, path="/v1/enqueue", **headers):
    return _call(url + path, frame,
                 dict({"Content-Type": "application/octet-stream"},
                      **headers))


def _shape(reply, replica):
    """A reply as compared across packages: status, the body's keys (or
    its text), and whether X-Replica-Id named the engine."""
    status, headers, body = reply
    try:
        doc = json.loads(body)
        what = sorted(doc) if isinstance(doc, dict) else doc
    except ValueError:
        what = body.decode()[:40]
    return status, what, headers.get("X-Replica-Id") == replica


def _both(dense, scenario, started=True, **params):
    """Run ``scenario(pkg, engine, url)`` against a JAX and a port engine;
    returns both transcripts."""
    out = {}
    for pkg in PKGS:
        s = _engine(pkg, dense, **params)
        server = None
        if started:
            s.start()
            url = s._http.url
        else:
            server = HTTP[pkg].HealthServer(s, port=0).start()
            url = server.url
        try:
            out[pkg] = scenario(pkg, s, url)
        finally:
            if server is not None:
                server.stop()
            s.shutdown()
    return out


def _frame(pkg, uri, x=None, **kw):
    x = np.arange(DIM, dtype="<f4") if x is None else x
    return WIRE[pkg].encode_tensor_frame(uri, x, **kw)


def test_binary_roundtrip_matches_jax(dense):
    def scenario(pkg, s, url):
        t = [_shape(_post_frame(url, _frame(pkg, "b-1"),
                                path="/v1/enqueue?timeout_s=15"),
                    s.replica_id)]
        st, hd, body = _call(url + "/v1/result/b-1?timeout_s=15")
        res = json.loads(body)
        t.append((st, sorted(res), hd["X-Replica-Id"] == s.replica_id))
        t.append(_call(url + "/v1/result/nope")[::2])
        st, _, body = _post_frame(url, _frame(pkg, "b-2")[:-2])
        t.append((st, json.loads(body)["error"]))
        t.append(s.queue.depth())
        return t, res["value"]

    out = _both(dense, scenario)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][2] == (404, b'{"ready": false, "uri": "nope"}')
    assert out["port"][0][3][0] == 400
    got, want = out["port"][1], out["jax"][1]
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               atol=1e-6)


def test_json_fallback_deadline_and_garbage_match_jax(dense):
    def scenario(pkg, s, url):
        t = []
        st, hd, body = _call(
            url + "/v1/enqueue?timeout_s=15",
            json.dumps({"uri": "j-1", "data": [0.1] * DIM}).encode(),
            {"Content-Type": "application/json"})
        doc = json.loads(body)
        t.append((st, sorted(doc), doc["deadline_ns"] > time.time_ns()))
        t.append(_shape(_call(url + "/v1/result/j-1?timeout_s=15"),
                        s.replica_id))
        st, _, body = _post_frame(url, b"\x01\x02garbage")
        t.append((st, json.loads(body)["error"][:40]))
        return t

    out = _both(dense, scenario)
    assert out["port"] == out["jax"]
    assert [r[0] for r in out["port"]] == [200, 200, 400]


def test_queue_full_429_and_drain_503_match_jax(dense):
    def scenario(pkg, s, url):
        codes = []
        for i in range(5):
            st, hd, _ = _post_frame(url, WIRE[pkg].restamp_frame(
                _frame(pkg, "f")))
            codes.append((st, hd.get("Retry-After")))
        s.queue.close_admission()
        st, hd, body = _post_frame(url, _frame(pkg, "f"))
        codes.append((st, hd.get("Retry-After")))
        return codes

    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].InProcQueue(max_depth=3)
        s = _engine(pkg, dense, queue=q)
        server = HTTP[pkg].HealthServer(s, port=0).start()
        try:
            out[pkg] = scenario(pkg, s, server.url)
        finally:
            server.stop()
            s.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"] == [(200, None)] * 3 + [(429, "1")] * 2 + [(503, "5")]


def test_traversal_uris_rejected_like_jax(dense, tmp_path):
    out = {}
    for pkg in PKGS:
        q = QUEUES[pkg].FileQueue(str(tmp_path / pkg))
        (tmp_path / pkg / "secret.json").write_text('{"leak": true}')
        s = _engine(pkg, dense, queue=q)
        s.start()
        url = s._http.url
        try:
            t = [_call(url + "/v1/result/..%2Fsecret")[::2]]
            for bad in ("a/b", "../x", "."):
                t.append(_post_json(url, {"uri": bad,
                                          "data": [0.1] * DIM})[::2])
            t.append(_post_frame(url, _frame(pkg, "../esc"))[::2])
            t.append(q.depth())
        finally:
            s.shutdown()
        out[pkg] = t
    assert out["port"] == out["jax"]
    assert {r[0] for r in out["port"][:-1]} == {400}
    assert out["port"][-1] == 0


def test_shm_records_rejected_like_jax(dense):
    spoof = {"name": "any_host_segment", "slot": 0, "gen": 1, "len": 16,
             "slots": 4, "slot_bytes": 64}

    def scenario(pkg, s, url):
        t = [_post_frame(url, _frame(pkg, "shm-1",
                                     np.ones(DIM, "<f4"),
                                     shm_ref=spoof))[::2]]
        for key, val in (("shm", spoof), ("payload", [1, 2, 3])):
            t.append(_post_json(url, {"uri": "shm-2", key: val})[::2])
        return t, s.queue.depth(), dict(WIRE[pkg]._ATTACHED)

    out = _both(dense, scenario, started=False)
    assert out["port"] == out["jax"]
    assert [r[0] for r in out["port"][0]] == [400] * 3
    assert out["port"][1:] == (0, {})


def test_untyped_fields_rejected_like_jax(dense):
    def scenario(pkg, s, url):
        t = []
        for bad in ({"uri": "x", "data": [1.0], "deadline_ns": "abc"},
                    {"uri": "x", "data": [1.0], "deadline_ns": 1e999},
                    {"uri": "x", "b64": 123},
                    {"uri": "x", "image": ["not", "a", "str"]},
                    {"uri": "x", "data": [1.0], "trace_id": 7},
                    {"uri": "x", "data": [1.0], "gen": [1]},
                    {"data": [1.0]}, [1, 2]):
            t.append(_post_json(url, bad)[::2])
        w = WIRE[pkg]
        for header in ({"uri": "x", "deadline_ns": "abc"}, {"uri": 123},
                       {"uri": "x", "trace_id": 5}):
            t.append(_post_frame(url, w.encode_frame(
                header, payload=np.ones(DIM, "<f4")))[::2])
        t.append(s.queue.depth())
        st, _, body = _post_json(url, {"uri": 123, "data": [1.0] * DIM,
                                       "wire_bytes": "z",
                                       "wire_fmt": "spoof"})
        ((rid, rec),) = s.queue.read_batch(1)
        t.append((st, json.loads(body)["uri"], rid,
                  "wire_bytes" in rec or "wire_fmt" in rec))
        return t

    out = _both(dense, scenario, started=False)
    assert out["port"] == out["jax"]
    assert {r[0] for r in out["port"][:11]} == {400}
    assert out["port"][11:] == [0, (200, "123", "123", False)]


def test_longpoll_cap_matches_jax(dense, monkeypatch):
    for mod in HTTP.values():
        monkeypatch.setattr(mod, "LONGPOLL_MAX_INFLIGHT", 1)

    def scenario(pkg, s, url):
        t = []
        q = s.queue
        threading.Timer(0.3, q.put_result,
                        args=("late", {"value": [3.0]})).start()
        t.append(_call(url + "/v1/result/late?timeout_s=inf")[::2])
        parked = threading.Thread(
            target=_call, args=(url + "/v1/result/parked?timeout_s=10",),
            daemon=True)
        parked.start()
        server = s._http
        deadline = time.time() + 5
        while server._longpoll_slots._value and time.time() < deadline:
            time.sleep(0.01)
        t0 = time.time()
        st, hd, body = _call(url + "/v1/result/other?timeout_s=10")
        t.append((st, hd.get("Retry-After"), time.time() - t0 < 5))
        q.put_result("ready", {"value": [1.0]})
        t.append(_call(url + "/v1/result/ready?timeout_s=10")[::2])
        t.append(_call(url + "/v1/result/other")[0])
        t.append(_call(url + "/v1/result/other?timeout_s=nan")[0])
        st, _, body = _post_json(url, {"uri": "inf-1", "data": [0.1]},
                                 path="/v1/enqueue?timeout_s=inf")
        t.append((st, sorted(json.loads(body))))
        q.put_result("parked", {"value": [2.0]})
        parked.join(timeout=5)
        t.append(parked.is_alive())
        return t

    out = _both(dense, scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1] == (503, "1", True)
    assert out["port"][-1] is False


def test_gateway_off_keeps_probes_only_like_jax(dense):
    def scenario(pkg, s, url):
        return [_post_json(url, {})[0],
                _call(url + "/v1/result/x")[0],
                _call(url + "/healthz")[0], _call(url + "/readyz")[0],
                _call(url + "/metrics")[0]]

    out = _both(dense, scenario, gateway=False)
    assert out["port"] == out["jax"] == [404, 404, 200, 200, 200]


def test_endpoint_histograms_match_jax(dense):
    def scenario(pkg, s, url):
        _post_frame(url, _frame(pkg, "m-1"))
        _call(url + "/v1/result/m-1?timeout_s=15")
        _post_json(url, {"uri": "a/b"})
        deadline = time.time() + 5
        while time.time() < deadline:
            prom = s.prom_metrics()
            if 'gateway_request_bytes_count{endpoint="result"}' in prom:
                break
            time.sleep(0.02)
        lat = s.registry.histogram("gateway_request_seconds",
                                   labels=("endpoint",))
        nb = s.registry.histogram("gateway_request_bytes",
                                  labels=("endpoint",))
        return {ep: (lat.labels(endpoint=ep).count,
                     nb.labels(endpoint=ep).count)
                for ep in ("enqueue", "result")}

    out = _both(dense, scenario)
    assert out["port"] == out["jax"] == {"enqueue": (2, 2),
                                         "result": (1, 1)}


def test_traceparent_continuation_matches_jax(dense):
    """An inbound ``traceparent`` is continued: the record carries its
    trace id, the gateway span parents under the inbound span and the
    stamped context names the gateway span; an unsampled inbound context
    records no gateway span."""
    tid, sid = "ab" * 8, "cd" * 8
    tp = f"00-{tid.zfill(32)}-{sid}-01"

    def scenario(pkg, s, url):
        t = []
        for flags, uri in (("01", "tp-1"), ("00", "tp-2")):
            st, _, body = _post_json(url, {"uri": uri, "data": [0.1] * DIM},
                                     traceparent=tp[:-2] + flags)
            t.append((st, json.loads(body)["trace_id"]))
        st, _, body = _post_frame(url, _frame(pkg, "tp-3"),
                                  traceparent=tp)
        t.append((st, json.loads(body)["trace_id"]))
        recs = dict(s.queue.read_batch(3))
        # the gateway records its span after it has replied
        deadline = time.time() + 5
        while True:
            gw = [sp for sp in s.tracer.spans(tid)
                  if sp["stage"] == "gateway"]
            if len(gw) >= 2 or time.time() > deadline:
                break
            time.sleep(0.01)
        t.append(sorted((sp["uri"], sp["parent_id"]) for sp in gw))
        ctx = {uri: recs[uri]["trace_ctx"]["tp"] for uri in ("tp-1",
                                                             "tp-2")}
        spans = {sp["uri"]: sp["span_id"] for sp in gw}
        t.append(ctx["tp-1"] == f"00-{tid.zfill(32)}-{spans['tp-1']}-01")
        t.append(ctx["tp-2"].startswith(f"00-{tid.zfill(32)}-")
                 and ctx["tp-2"].endswith("-00"))
        return t

    out = _both(dense, scenario, started=False)
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [(200, tid)] * 3
    assert out["port"][3] == [("tp-1", sid), ("tp-3", sid)]


def test_admission_429_with_computed_retry_after_like_jax(dense):
    def scenario(pkg, s, url):
        hdrs = {"X-Tenant": "acme", "X-Priority": "interactive"}
        t = [_post_json(url, {"uri": "ok-1", "data": [0.1] * DIM},
                        **hdrs)[0]]
        st, hd, body = _post_json(url, {"uri": "rej", "data": [0.1] * DIM},
                                  **hdrs)
        b = s._admission._buckets[("acme", "interactive")]
        t.append((st, json.loads(body),
                  hd["Retry-After"] == f"{(1 - b.tokens) / b.rate:.3f}",
                  1.5 < float(hd["Retry-After"]) <= 2.0))
        t.append(_post_json(url, {"uri": "ok-2", "data": [0.1] * DIM},
                            **dict(hdrs, **{"X-Tenant": "other-co"}))[0])
        uris = [rec["uri"] for _, rec in s.queue.read_batch(8)]
        t.append((uris, s.health()["admission"]["rejected"]))
        return t

    out = _both(dense, scenario, started=False,
                admission={"rate": 0.5, "burst": 1.0})
    assert out["port"] == out["jax"]
    assert out["port"][1][0] == 429 and out["port"][1][1]["reason"] == \
        "tenant_rate" and out["port"][1][2:] == (True, True)
    assert out["port"][3] == (["ok-1", "ok-2"], 1)


def _keys(doc, depth=1):
    if not isinstance(doc, dict) or depth == 0:
        return type(doc).__name__
    return {k: _keys(v, depth - 1) for k, v in doc.items()}


# keys of the port's health document that the JAX one has not: the device
# the model serves on, and the generation plane's decode-state breakdown
PORT_ONLY = {"device", "kv_state"}


def test_health_documents_match_jax(dense):
    """The documents' key sets, block by block: ``/healthz`` (with the
    armour's blocks), ``/readyz``, ``/metrics`` (JSON) and the series of
    ``/metrics?format=prom``."""
    def scenario(pkg, s, url):
        _post_frame(url, _frame(pkg, "h-1"), **{"X-Tenant": "acme"})
        _call(url + "/v1/result/h-1?timeout_s=15")
        st, hd, body = _call(url + "/healthz")
        h = json.loads(body)
        blocks = {k: sorted(h[k]) for k in
                  ("resources", "usage", "admission", "brownout", "knobs",
                   "breaker", "recorder", "warmup", "stages")}
        blocks["resources.executables"] = sorted(
            h["resources"]["executables"])
        blocks["usage.acme"] = sorted(h["usage"]["tenants"]["acme"])
        st2, _, body2 = _call(url + "/readyz")
        st3, _, body3 = _call(url + "/metrics")
        st4, hd4, prom = _call(url + "/metrics?format=prom")
        series = {line.split("{")[0].split(" ")[0]
                  for line in prom.decode().splitlines()
                  if line and not line.startswith("#")}
        return (st, sorted(set(h) - PORT_ONLY), blocks,
                (st2, sorted(json.loads(body2))),
                (st3, sorted(json.loads(body3))),
                (st4, hd4["Content-Type"]), series, sorted(h["process"]))

    out = _both(dense, scenario, admission={"rate": 100.0},
                brownout={}, serving_slo={"latency_ms": 1000.0})
    j, t = out["jax"], out["port"]
    assert t[:6] == j[:6]
    assert t[7] == j[7]
    # every series of the JAX exposition is in the port's
    # the mesh gauge waits for multi-GPU serving
    assert j[6] - {"inference_mesh_devices"} <= t[6], sorted(j[6] - t[6])
    assert {"serving_hbm_bytes", "serving_device_seconds_total",
            "gateway_request_seconds_count", "process_open_fds"} <= t[6]


def test_profile_gating_matches_jax(dense):
    """``profiling=False`` removes the route; a non-positive ``seconds``
    is a 400; an unknown POST route a 404 — in both packages, and no
    trace starts."""
    out = {}
    for pkg in PKGS:
        t = []
        for profiling in (False, True):
            s = _engine(pkg, dense, profiling=profiling)
            server = HTTP[pkg].HealthServer(s, port=0).start()
            try:
                for q in ("seconds=1" if not profiling else "seconds=0",
                          "seconds=-2"):
                    t.append(_call(server.url + "/debug/profile?" + q, b"",
                                   method="POST")[::2])
                t.append(_call(server.url + "/debug/nope", b"",
                               method="POST")[0])
            finally:
                server.stop()
                s.shutdown()
        out[pkg] = t
    assert out["port"] == out["jax"]
    off = (404, b'{"error": "profiling disabled (params.profiling)"}')
    bad = (400, b'{"error": "seconds must be > 0"}')
    assert out["port"] == [off, off, 404, bad, bad, 404]


def _profile_events(s):
    return [e for e in s.recorder.events()
            if e.get("event", "").startswith("profile_")
            and e.get("replica") == s.replica_id]


def test_profile_trace_written_and_second_request_409(dense, tmp_path):
    s = _engine("port", dense)
    s.profile_dir = str(tmp_path / "profiles")
    s.start()
    try:
        url = s._http.url + "/debug/profile"
        st, hd, body = _call(url + "?seconds=0.2", b"", method="POST")
        doc = json.loads(body)
        assert st == 202 and sorted(doc) == ["path", "profiling",
                                             "replica_id", "seconds"]
        assert doc["path"].startswith(s.profile_dir)
        assert hd["X-Replica-Id"] == s.replica_id
        st2, hd2, body2 = _call(url + "?seconds=0.2", b"", method="POST")
        assert st2 == 409 and hd2["Retry-After"] == "5", body2
        deadline = time.monotonic() + 120
        while not any(e["event"] != "profile_start"
                      for e in _profile_events(s)):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        ev = _profile_events(s)
        assert [e["event"] for e in ev] == ["profile_start", "profile_done"]
        assert ev[1]["device_events"] == 0 and ev[1]["device_work"] == 0
        with open(os.path.join(doc["path"], "trace.json")) as f:
            assert "traceEvents" in json.load(f)
        # the session is over: another one may start
        deadline = time.monotonic() + 10
        while _impl.PROFILER_LOCK.locked():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # a profiler session of the process (card_launches holds the lock
        # for its own) refuses the trace
        with _impl.PROFILER_LOCK:
            st3, _, body3 = _call(url + "?seconds=0.2", b"", method="POST")
            with pytest.raises(RuntimeError, match="one at a time"):
                s.start_profile(0.2)
        assert st3 == 409, body3
    finally:
        s.shutdown()


def test_profile_failure_posts_profile_error(dense, tmp_path, monkeypatch):
    """A trace that fails posts ``profile_error``, releases the session,
    and the engine keeps serving."""
    import torch.profiler as tprof

    def broken(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tprof, "profile", broken)
    q = tqueues.InProcQueue()
    s = _engine("port", dense, queue=q)
    s.start()
    try:
        s.start_profile(0.05, out_dir=str(tmp_path))
        deadline = time.monotonic() + 30
        while len(_profile_events(s)) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        ev = _profile_events(s)[-1]
        assert ev["event"] == "profile_error"
        assert "no profiler here" in ev["error"]
        while _impl.PROFILER_LOCK.locked():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        st, _, _ = _post_frame(s._http.url, _frame("port", "after"))
        assert st == 200
        st, _, body = _call(s._http.url + "/v1/result/after?timeout_s=15")
        assert st == 200 and "value" in json.loads(body)
    finally:
        s.shutdown()


def test_profile_starts_and_stops_between_decode_boundaries():
    """On the generation plane the trace starts (and stops) only between
    decode boundaries: while a boundary holds the batcher's lock, an
    armed trace waits."""
    im = InferenceModel(device="cpu").do_load_model(
        TransformerLM(**GEO, seed=3, device="cpu"))
    s = teng.ClusterServing(im, tqueues.InProcQueue(), teng.ServingParams(
        generation=GEN, replica_id=f"gw-gen-{next(_IDS)}"))
    try:
        with s._batcher._device_lock:
            s.start_profile(0.05)
            time.sleep(0.5)
            assert [e["event"] for e in _profile_events(s)] == \
                ["profile_start"]
        deadline = time.monotonic() + 60
        while len(_profile_events(s)) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert _profile_events(s)[-1]["event"] == "profile_done"
    finally:
        while _impl.PROFILER_LOCK.locked():
            time.sleep(0.01)
        s.shutdown()


# -- generation over the gateway ------------------------------------------------

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = dict(paged=True, block_len=8, max_active_slots=4, max_tokens=12,
           max_prompt_len=16, stream_interval=2, decode_quantum=2)
PROMPTS = {"a": [3, 9, 27, 4, 12], "b": list(range(1, 17)), "c": [40, 41],
           "d": [7, 7, 7]}


def test_generation_over_the_gateway():
    """Binary frames from two tenants through ``/v1/enqueue``, results by
    long-poll: every token list equals a direct run of the batcher, every
    partial seen is a prefix of its final list, results carry their
    tenant, and the tokens charged to each tenant are its delivered tokens
    less each request's prefill token."""
    im = InferenceModel(device="cpu").do_load_model(
        TransformerLM(**GEO, seed=3, device="cpu"))
    s = teng.ClusterServing(im, tqueues.InProcQueue(), teng.ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=GEN, http_port=0,
        admission={"rate": 100.0}))
    s.start()
    partials, finals = {}, {}
    try:
        url = s._http.url
        for i, (rid, p) in enumerate(PROMPTS.items()):
            st, hd, _ = _post_frame(
                url, twire.encode_tensor_frame(rid, np.asarray(p, "<f4")),
                **{"X-Tenant": "acme" if i % 2 else "zeta",
                   "X-Priority": "batch"})
            assert st == 200 and hd["X-Replica-Id"] == s.replica_id
        for rid in PROMPTS:
            while rid not in finals:
                st, _, body = _call(url + f"/v1/result/{rid}?timeout_s=0.01")
                if st == 404:
                    continue
                doc = json.loads(body)
                if doc.get("partial"):
                    partials.setdefault(rid, []).append(doc["tokens"])
                else:
                    finals[rid] = doc
        usage = s.health()["usage"]["tenants"]
    finally:
        s.shutdown(drain_s=2.0)
    ref = tgen.ContinuousBatcher(im, tgen.GenerationParams(**GEN))
    for rid, p in PROMPTS.items():
        ref.submit(tgen.GenRequest(rid, np.asarray(p, np.float32)))
    want = {}
    while not ref.idle:
        for ev in ref.step():
            if ev.kind == "finish":
                want[ev.rid] = ev.tokens
    for i, rid in enumerate(PROMPTS):
        assert finals[rid]["value"]["tokens"] == want[rid]
        assert finals[rid]["tenant"] == ("acme" if i % 2 else "zeta")
        for part in partials.get(rid, []):
            assert part == want[rid][:len(part)]
    for ten in ("acme", "zeta"):
        mine = [rid for i, rid in enumerate(PROMPTS)
                if ("acme" if i % 2 else "zeta") == ten]
        assert usage[ten]["records"] == len(mine)
        assert usage[ten]["tokens"] == sum(len(want[r]) - 1 for r in mine)
