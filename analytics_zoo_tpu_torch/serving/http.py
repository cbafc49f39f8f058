"""Serving HTTP layer — availability probes and the ingestion gateway: the
port of the JAX package's ``serving/http.py``.

``HealthServer`` carries both surfaces of a replica's HTTP port.

Probes:

- ``GET /healthz``  — liveness: 200 while the engine's workers are running
  (or restarting under supervision), 503 once a worker is FAILED past its
  restart cap or the engine stopped.  Body: the full
  ``ClusterServing.health()`` document.
- ``GET /readyz``   — readiness: 200 only when the engine can take traffic
  (workers alive, breakers not open, queue depth under the admission
  threshold, backend reachable, not draining, warm-up done).  503 with
  ``{"ready": false, "reasons": [...]}`` otherwise; while the warm-up
  runs, the reasons carry ``warming (k/n programs)`` and the body a
  ``warmup`` progress block.
- ``GET /metrics``  — JSON counters; with ``?format=prom`` or a
  text/plain Accept header, the Prometheus text exposition v0.0.4 of the
  engine's registry.
- ``POST /debug/profile?seconds=N`` — one ``torch.profiler`` trace of
  this process (``ClusterServing.start_profile``): 202 with its path, 409
  while another trace (or any profiler session of the process) runs, 404
  when ``params.profiling`` is off.

Ingestion gateway (any client, any language):

- ``POST /v1/enqueue`` — submit one record.  Content-Type negotiated:
  ``application/octet-stream`` is a BINARY FRAME (serving/wire.py layout —
  build it in any language: magic ``AZ`` + version + flags + u32 header
  length + header JSON + raw little-endian payload), validated at the edge
  (malformed -> 400, never enqueued); anything JSON-ish is the legacy
  record dict (``{"uri", "b64", "dtype", "shape"}``) for curl-from-anywhere
  ergonomics.  The shm lane is a SAME-HOST trusted-native-client
  transport: a frame or JSON record carrying a shm slot reference (or a
  raw ``payload``) is rejected 400 here — honoring a remote-supplied ref
  would make the engine attach any named shared-memory segment on the
  host and serve bytes derived from it.  The gateway issues a ``trace_id``
  at ingest when the record carries none, and ``?timeout_s=S`` stamps the
  end-to-end ``deadline_ns`` AT THE EDGE so deadline shedding covers HTTP
  traffic too.  Admission is enforced here: the tenant gate
  (``ClusterServing.admit_record``, from the ``X-Api-Key`` / ``X-Tenant``
  and ``X-Priority`` headers) answers **429** with a ``Retry-After``
  computed from the tenant's bucket, a full queue **429**, a draining
  queue **503** — the flood never reaches the backend unbounded.
  Reply: ``{"uri", "trace_id", "deadline_ns"?}``.
- ``GET /v1/result/<uri>`` — fetch the prediction.  ``?timeout_s=S`` long-
  polls (bounded by ``LONGPOLL_CAP_S``) with backoff until the result
  lands; a miss answers 404 ``{"ready": false}`` so pollers can
  distinguish "not yet" from a transport error.  Each parked long-poll
  pins one handler thread, so concurrent pollers are capped at
  ``LONGPOLL_MAX_INFLIGHT``: overflow degrades to one immediate lookup —
  200 on a hit, else **503** with ``Retry-After`` — instead of letting a
  client exhaust gateway threads/FDs with hanging polls.  Error results
  (quarantine / deadline-shed markers) return 200 with the
  ``{"error": ...}`` body — terminal state, not a gateway failure.
  Generation deployments stream tokens-so-far: a ``{"partial": true,
  "tokens": [...]}`` result is NOT terminal — the long-poll keeps waiting
  for the final result and returns the freshest partial at the deadline,
  so pollers see progress between polls instead of ``{"ready": false}``.

Per-endpoint telemetry rides the engine's registry:
``gateway_request_seconds{endpoint=}`` and
``gateway_request_bytes{endpoint=}`` histograms, scrape-ready next to the
serving stage metrics.

Every response carries an ``X-Replica-Id`` header.
``ServingParams.gateway=False`` strips the /v1 routes for deployments that
want probe-only ports.

Handlers only parse, stamp and enqueue (or read the result store); they
never touch the device.

Zero dependencies: `ThreadingHTTPServer` on a daemon thread, started by
``ClusterServing.start()`` when ``ServingParams.http_port`` is set (0 picks
an ephemeral port, exposed as ``HealthServer.port``) and stopped by
``shutdown()`` after the drain completes.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

# long-poll ceiling for GET /v1/result: bounds worker-thread occupancy per
# hanging client (ThreadingHTTPServer spawns one thread per request)
LONGPOLL_CAP_S = 30.0
# concurrent parked long-polls per gateway: ThreadingHTTPServer is
# unbounded, so without this a client opening many long-polls pins one
# thread each for up to LONGPOLL_CAP_S; overflow answers an immediate
# lookup (200 on hit, else 503 + Retry-After) instead of parking
LONGPOLL_MAX_INFLIGHT = 64
# largest accepted request body; a frame bigger than this answers 413
MAX_BODY_BYTES = 64 * 1024 * 1024


class HealthServer:
    """Probes + ingestion gateway over a serving engine."""

    def __init__(self, serving, host: str = "127.0.0.1", port: int = 0):
        self.serving = serving
        self.host = host
        self.port = port                    # actual port after start()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # admission for parked long-polls (see LONGPOLL_MAX_INFLIGHT)
        self._longpoll_slots = threading.BoundedSemaphore(
            LONGPOLL_MAX_INFLIGHT)
        # gateway telemetry in the engine's registry; guarded —
        # exotic servings (tests wrapping a stub) may lack a registry
        self._lat = self._bytes = None
        registry = getattr(serving, "registry", None)
        if registry is not None:
            self._lat = registry.histogram(
                "gateway_request_seconds",
                "Gateway request latency, by endpoint",
                labels=("endpoint",))
            self._bytes = registry.histogram(
                "gateway_request_bytes",
                "Gateway request/response body bytes, by endpoint",
                labels=("endpoint",),
                buckets=(64, 256, 1024, 4096, 16384, 65536, 262144,
                         1048576, 4194304, 16777216))

    def _observe(self, endpoint: str, t0: float, nbytes: int) -> None:
        if self._lat is not None:
            self._lat.labels(endpoint=endpoint).record(
                time.monotonic() - t0)
            self._bytes.labels(endpoint=endpoint).record(nbytes)

    def start(self) -> "HealthServer":
        serving = self.serving
        gateway = self
        gateway_on = bool(getattr(
            getattr(serving, "params", None), "gateway", True))

        class _Handler(BaseHTTPRequestHandler):
            # socket timeout for request-line/header/BODY reads: a client
            # that declares Content-Length and under-sends must not pin a
            # handler thread forever (the long-poll loop sleeps server-side
            # and is bounded separately by LONGPOLL_CAP_S)
            timeout = 30

            def log_message(self, fmt, *args):  # noqa: A003 — silence stderr
                logger.debug("probe: " + fmt, *args)

            def _replica_header(self) -> None:
                # every probe answer names the replica that served it,
                # so a load balancer / operator can attribute a flip without
                # parsing the body (readiness carries identity)
                replica = getattr(serving, "replica_id", None)
                if replica:
                    self.send_header("X-Replica-Id", str(replica))

            def _reply(self, status: int, doc, extra_headers=()) -> int:
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self._replica_header()
                self.end_headers()
                self.wfile.write(body)
                return len(body)

            def _reply_text(self, status: int, text: str,
                            content_type: str) -> None:
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self._replica_header()
                self.end_headers()
                self.wfile.write(body)

            def _wants_prom(self, query: str) -> bool:
                from urllib.parse import parse_qs
                fmt = (parse_qs(query).get("format") or [None])[0]
                if fmt is not None:
                    return fmt == "prom"
                # content negotiation: a scraper asking for text/plain (and
                # not json) gets the exposition format; default stays JSON
                accept = self.headers.get("Accept", "") or ""
                return ("text/plain" in accept
                        and "application/json" not in accept)

            @staticmethod
            def _uri_ok(uri: str) -> bool:
                """Edge validation for client-controlled uris: FileQueue
                joins the uri into filesystem paths (results/<uri>.json,
                stream spool names), so a traversal-shaped uri must never
                reach the backend.  Native clients are trusted code; the
                gateway is the first surface exposing uri to REMOTE
                callers."""
                return (bool(uri) and len(uri) <= 256
                        and not any(c in uri for c in "/\\\x00")
                        and uri not in (".", ".."))

            @staticmethod
            def _deadline_ok(dl) -> bool:
                """A record's deadline_ns is int()ed by the engine's shed
                gate OUTSIDE the per-record quarantine: a non-numeric
                value from a remote client must stop at the edge."""
                if dl is None:
                    return True
                try:
                    int(dl)
                except (TypeError, ValueError, OverflowError):
                    # OverflowError: json.loads accepts Infinity/1e999
                    return False
                return True

            @staticmethod
            def _query_float(query: str, key: str) -> Optional[float]:
                import math
                from urllib.parse import parse_qs
                raw = (parse_qs(query).get(key) or [None])[0]
                if raw is None:
                    return None
                try:
                    val = float(raw)
                except ValueError:
                    return None
                # nan poisons every comparison downstream — a long-poll
                # deadline of nan never expires AND never parks (an
                # uncapped 10ms spin pinning a handler thread forever).
                # inf stays: the result path clamps it to LONGPOLL_CAP_S
                # ("wait as long as you allow"), and the enqueue path
                # guards the deadline int() itself.
                return val if not math.isnan(val) else None

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                from urllib.parse import urlsplit
                parts = urlsplit(self.path)
                try:
                    if parts.path == "/healthz":
                        h = serving.health()
                        ok = bool(h.get("running"))
                        # every shed/reject/not-ready answer in
                        # the serving surface carries a Retry-After hint
                        self._reply(200 if ok else 503, h,
                                    extra_headers=(
                                        () if ok
                                        else (("Retry-After", "1"),)))
                    elif parts.path == "/readyz":
                        r = serving.ready()
                        ok = bool(r.get("ready"))
                        self._reply(200 if ok else 503, r,
                                    extra_headers=(
                                        () if ok
                                        else (("Retry-After", "1"),)))
                    elif parts.path == "/metrics":
                        if self._wants_prom(parts.query):
                            from analytics_zoo_tpu_torch.common.observability \
                                import MetricsRegistry
                            self._reply_text(200, serving.prom_metrics(),
                                             MetricsRegistry.CONTENT_TYPE)
                        else:
                            self._reply(200, serving.metrics())
                    elif gateway_on and \
                            parts.path.startswith("/v1/result/"):
                        self._get_result(parts)
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                except Exception as e:  # noqa: BLE001 — probe must answer
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            @staticmethod
            def _trace_state():
                """(tracer, sample_rate) — None tracer when the serving
                is a stub without one, or span recording is off."""
                tracer = getattr(serving, "tracer", None)
                params = getattr(serving, "params", None)
                if tracer is None or not getattr(params, "tracing", True):
                    return None, 0.0
                try:
                    rate = float(getattr(params, "trace_sample", 1.0))
                except (TypeError, ValueError):
                    rate = 1.0
                return tracer, rate

            def _result_poll_span(self, t0: float, uri: str, res) -> None:
                """A terminal result fetched through the gateway
                records a ``result_poll`` span under the record's trace,
                so the reconstructed timeline covers the client's wait on
                THIS side of the wire too."""
                from analytics_zoo_tpu_torch.common.observability import (
                    SpanContext, trace_sampled)
                tracer, rate = self._trace_state()
                if tracer is None or not isinstance(res, dict):
                    return
                tid = res.get("trace_id")
                if not tid:
                    return
                # verdict priority: the poll's OWN traceparent (clients
                # continuing an explicitly-unsampled context must stay
                # dark even when the poll lands on a replica that never
                # saw the enqueue — the LB re-route shape), then the
                # engine's per-trace memory, then the fleet-pure hash
                inbound = SpanContext.from_traceparent(
                    self.headers.get("traceparent"))
                if inbound is not None and inbound.trace_id == tid:
                    if not inbound.sampled:
                        return
                else:
                    meta = getattr(serving, "_trace_meta", {}).get(tid)
                    if meta is not None:
                        if not meta[1]:
                            return
                    elif not trace_sampled(tid, rate):
                        return
                # tenant attribution: the engine stamps the
                # record's tenant into the result doc, so "whose poll"
                # is answerable from the trace alone
                attrs = {}
                if isinstance(res.get("tenant"), str):
                    attrs["tenant"] = res["tenant"]
                if isinstance(res.get("priority"), str):
                    attrs["priority"] = res["priority"]
                tracer.span("result_poll", t0, time.monotonic(),
                            trace_id=tid, uri=uri, attrs=attrs or None)

            def _get_result(self, parts) -> None:
                """GET /v1/result/<uri>[?timeout_s=S] — long-poll the
                result table with backoff; bounded by LONGPOLL_CAP_S, with
                concurrent parked pollers capped at LONGPOLL_MAX_INFLIGHT
                (overflow degrades to one immediate lookup)."""
                from urllib.parse import unquote
                t0 = time.monotonic()
                nbytes = 0
                parked = False
                # every exit — hit, miss, rejection, or failure — lands in
                # the endpoint histograms: rejected/failed traffic is
                # exactly what they exist to attribute
                try:
                    uri = unquote(parts.path[len("/v1/result/"):])
                    if not self._uri_ok(uri):
                        nbytes = self._reply(400, {"error": "invalid uri"})
                        return
                    timeout_s = self._query_float(parts.query,
                                                  "timeout_s") or 0.0
                    deadline = t0 + min(max(timeout_s, 0.0),
                                        LONGPOLL_CAP_S)
                    if deadline > t0:
                        parked = gateway._longpoll_slots.acquire(
                            blocking=False)
                        if not parked:
                            # long-poll slots exhausted: one immediate
                            # lookup, never a parked thread
                            res = serving.queue.get_result(uri)
                            if res is not None:
                                nbytes = self._reply(200, res)
                                if not (isinstance(res, dict)
                                        and res.get("partial")):
                                    # overload is exactly when trace-based
                                    # diagnosis matters: the fast path
                                    # records the leg too
                                    self._result_poll_span(t0, uri, res)
                            else:
                                nbytes = self._reply(
                                    503,
                                    {"error": "long-poll capacity "
                                              "exhausted", "uri": uri},
                                    extra_headers=(("Retry-After", "1"),))
                            return
                    poll = 0.01
                    partial = None
                    while True:
                        res = serving.queue.get_result(uri)
                        if res is not None:
                            if isinstance(res, dict) and res.get("partial"):
                                # streaming partial (continuous
                                # batching): tokens-so-far, not terminal —
                                # keep polling for the final result and
                                # fall back to the freshest partial at the
                                # deadline so the long-poll returns
                                # progress instead of "not yet"
                                partial = res
                            else:
                                nbytes = self._reply(200, res)
                                self._result_poll_span(t0, uri, res)
                                return
                        now = time.monotonic()
                        if now >= deadline:
                            break
                        time.sleep(min(poll, deadline - now))
                        poll = min(poll * 1.5, 0.25)
                    if partial is not None:
                        nbytes = self._reply(200, partial)
                    else:
                        nbytes = self._reply(404,
                                             {"ready": False, "uri": uri})
                finally:
                    if parked:
                        gateway._longpoll_slots.release()
                    gateway._observe("result", t0, nbytes)

            def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
                from urllib.parse import urlsplit
                parts = urlsplit(self.path)
                if parts.path == "/debug/profile":
                    # on-demand device profiling: PROBE surface
                    # only — the LB proxies /v1/* and nothing else, so
                    # /debug never faces remote gateway traffic; the
                    # params.profiling gate removes the route entirely
                    self._profile(parts)
                    return
                if not (gateway_on and parts.path == "/v1/enqueue"):
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    self._enqueue(parts)
                except Exception as e:  # noqa: BLE001 — gateway must answer
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _profile(self, parts) -> None:
                """POST /debug/profile?seconds=N — start one
                ``torch.profiler`` trace into the deployment's profile dir
                (202 + the path), 409 while one is already running, 404
                when ``params.profiling`` is off."""
                if not bool(getattr(getattr(serving, "params", None),
                                    "profiling", False)):
                    self._reply(404, {"error": "profiling disabled "
                                               "(params.profiling)"})
                    return
                start = getattr(serving, "start_profile", None)
                if not callable(start):
                    self._reply(404, {"error": "engine exposes no "
                                               "profiler"})
                    return
                seconds = self._query_float(parts.query, "seconds")
                if seconds is None:
                    seconds = 5.0
                if seconds <= 0:
                    self._reply(400, {"error": "seconds must be > 0"})
                    return
                try:
                    doc = start(seconds)
                except RuntimeError as e:
                    self._reply(409, {"error": str(e)},
                                extra_headers=(("Retry-After", "5"),))
                    return
                except Exception as e:  # noqa: BLE001 — profiler missing
                    self._reply(500,
                                {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply(202, doc)

            def _enqueue(self, parts) -> None:
                """POST /v1/enqueue[?timeout_s=S] — binary frame or JSON
                record, edge validation + admission + trace/deadline
                stamping.  An inbound ``traceparent`` header (the
                LB's root span, or any W3C-compliant upstream) is
                CONTINUED — its trace_id becomes the record's, and the
                gateway's own span parents under it; either way the
                propagated context (traceparent naming the gateway span
                as the engine's parent + the ingest timestamp the
                queue-wait span is computed from) is stamped into the
                record / frame header."""
                from analytics_zoo_tpu_torch.common.observability import (
                    SpanContext, new_span_id, new_trace_id, trace_sampled)
                from analytics_zoo_tpu_torch.serving import wire as _wire
                from analytics_zoo_tpu_torch.serving.queues import (
                    QueueClosed, QueueFull)
                t0 = time.monotonic()
                length = 0
                # every exit path — accept, reject, malformed, failure —
                # lands in the endpoint histograms (rejected traffic is
                # exactly what they exist to attribute)
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        length = 0
                    if length <= 0:
                        self._reply(411,
                                    {"error": "Content-Length required"})
                        return
                    if length > MAX_BODY_BYTES:
                        self._reply(413,
                                    {"error": f"body {length} bytes > "
                                              f"cap {MAX_BODY_BYTES}"})
                        return
                    body = self.rfile.read(length)
                    # tenant-aware admission: identity + priority
                    # come from the HEADERS — this is the trust edge, the
                    # same one that owns trace_ctx — and the decision is
                    # made before any parse/stamp work is spent on a
                    # record that will be rejected.  Rejections answer
                    # 429 with a Retry-After COMPUTED from the tenant
                    # bucket's refill (not a constant), so a compliant
                    # client converges on its admitted rate.
                    tenant = (self.headers.get("X-Api-Key")
                              or self.headers.get("X-Tenant"))
                    prio_hdr = self.headers.get("X-Priority")
                    admit_fn = getattr(serving, "admit_record", None)
                    decision = admit_fn(tenant, prio_hdr) \
                        if callable(admit_fn) else None
                    # identity is stamped on EVERY record, not
                    # just when the admission armor is on: with no
                    # controller the gateway normalizes the headers
                    # itself, so downstream attribution (metrics, spans,
                    # usage journal) never depends on admission config
                    if decision is not None:
                        rec_tenant = decision.tenant
                        rec_priority = decision.priority
                    else:
                        from analytics_zoo_tpu_torch.serving.admission import (
                            normalize_priority, normalize_tenant)
                        rec_tenant = normalize_tenant(tenant)
                        rec_priority = normalize_priority(prio_hdr)
                    if decision is not None and not decision.admitted:
                        self._reply(
                            429,
                            {"error": "admission rejected "
                                      f"({decision.reason})",
                             "reason": decision.reason,
                             "tenant": decision.tenant,
                             "priority": decision.priority},
                            extra_headers=(
                                ("Retry-After",
                                 f"{decision.retry_after_s:.3f}"),))
                        return
                    import math
                    timeout_s = self._query_float(parts.query, "timeout_s")
                    # inf = "no budget": no deadline stamped (int(inf)
                    # would overflow; the result path clamps instead)
                    deadline_ns = (time.time_ns() + int(timeout_s * 1e9)
                                   if timeout_s and math.isfinite(timeout_s)
                                   else None)
                    ctype = (self.headers.get("Content-Type")
                             or "").lower()
                    binary = "octet-stream" in ctype \
                        or _wire.is_frame(body)
                    # continue an upstream trace (LB root span) when the
                    # header parses; a malformed traceparent from an
                    # untrusted client degrades to a fresh root
                    inbound = SpanContext.from_traceparent(
                        self.headers.get("traceparent"))
                    trace_id = inbound.trace_id if inbound is not None \
                        else new_trace_id()
                    tracer, sample_rate = self._trace_state()
                    gw_span = new_span_id()

                    def _sampled_for(tid):
                        # the inbound verdict is authoritative only for
                        # the trace it was computed FOR: a client-stamped
                        # frame id that displaced the LB's root id gets
                        # its own pure-hash verdict, keeping the
                        # fleet-consistency invariant at partial rates
                        if inbound is not None \
                                and tid == inbound.trace_id:
                            return inbound.sampled
                        return trace_sampled(tid, sample_rate)

                    def _mk_ctx(hdr):
                        # the context names the frame's FINAL trace_id
                        # (a client-stamped one wins over the gateway's)
                        tid = hdr.get("trace_id") or trace_id
                        return {"tp": SpanContext(
                                    tid, gw_span,
                                    _sampled_for(tid)).to_traceparent(),
                                "ts": time.time_ns()}

                    if binary:
                        try:
                            # edge validation: a malformed frame is
                            # rejected HERE with the reason, never
                            # enqueued to poison the stream; restamp
                            # issues the ingest trace_id / edge deadline
                            # / span context without clobbering
                            # client-set ones
                            # overwrite_trace_ctx: every frame arriving
                            # HERE is remote by definition (native
                            # producers enqueue directly) — a client-
                            # supplied context would forge the queue-wait
                            # ingest timestamp (and through it the SLO
                            # burn the fleet merges as MAX) and
                            # mis-parent every engine span
                            # the trust edge also owns tenant/priority:
                            # a client-written tenant field in
                            # the frame would bill another tenant's
                            # bucket and jump the priority lanes
                            frame, header = \
                                _wire.restamp_frame_with_header(
                                    body, trace_id=trace_id,
                                    deadline_ns=deadline_ns,
                                    trace_ctx_fn=_mk_ctx,
                                    overwrite_trace_ctx=True,
                                    set_fields={
                                        "tenant": rec_tenant,
                                        "priority": rec_priority})
                        except _wire.FrameError as e:
                            self._reply(400, {"error": f"malformed "
                                                       f"frame: {e}"})
                            return
                        if "shm" in header:
                            # the shm lane is same-host trusted-client
                            # only: a remote ref would have the engine
                            # attach ANY named /dev/shm segment (and one
                            # spoofed geometry poisons the per-name
                            # attachment cache for legitimate producers)
                            self._reply(400,
                                        {"error": "shm frames are not "
                                                  "accepted over HTTP"})
                            return
                        if not isinstance(header["uri"], str):
                            # the frame carries the uri verbatim to the
                            # engine, which keys results by it: a non-str
                            # uri would serve under a key GET /v1/result
                            # can never look up
                            self._reply(400, {"error": "frame uri must "
                                                       "be a string"})
                            return
                        if not isinstance(header.get("trace_id"), str):
                            # a non-str client trace_id splits the trace
                            # at the LB (its sniffer requires str) and
                            # flows into results/spans as a junk key
                            self._reply(400,
                                        {"error": "frame trace_id must "
                                                  "be a string"})
                            return
                        record, uri = frame, header["uri"]
                        trace_id = header.get("trace_id", trace_id)
                        deadline_ns = header.get("deadline_ns")
                        if not self._deadline_ok(deadline_ns):
                            # the junk value is INSIDE the enqueued frame:
                            # the engine's shed gate int()s it outside the
                            # per-record quarantine, so it must not pass
                            self._reply(400,
                                        {"error": "frame deadline_ns "
                                                  "must be numeric"})
                            return
                    else:
                        try:
                            record = json.loads(body)
                        except ValueError as e:
                            self._reply(400,
                                        {"error": f"body is neither a "
                                                  f"binary frame nor "
                                                  f"JSON: {e}"})
                            return
                        if not isinstance(record, dict) or \
                                not record.get("uri"):
                            self._reply(400,
                                        {"error": "JSON record must be "
                                                  "an object with a "
                                                  "'uri'"})
                            return
                        if "shm" in record or "payload" in record:
                            # same edge stance as the frame path: 'shm'
                            # routes the engine into attaching arbitrary
                            # host segments, 'payload' is the internal
                            # frame-decoded form — neither is a remote-
                            # client surface
                            self._reply(400,
                                        {"error": "'shm'/'payload' "
                                                  "records are not "
                                                  "accepted over HTTP"})
                            return
                        # typed edge validation: the engine's read loop
                        # runs OUTSIDE the per-record quarantine, so a
                        # junk-typed field here would crash-loop the
                        # preprocess worker (restart -> redelivery ->
                        # crash again), not quarantine one record
                        for key in ("b64", "image"):
                            if key in record and \
                                    not isinstance(record[key], str):
                                self._reply(400,
                                            {"error": f"'{key}' must be "
                                                      f"a base64 string"})
                                return
                        if "trace_id" in record and \
                                not isinstance(record["trace_id"], str):
                            # same edge stance as the frame path: a
                            # non-str trace_id splits the trace at the
                            # LB's sniffer and pollutes spans/results
                            self._reply(400,
                                        {"error": "'trace_id' must be "
                                                  "a string"})
                            return
                        if "gen" in record and \
                                not isinstance(record["gen"], dict):
                            # generation options: the scheduler
                            # clamps the VALUES, but the container type is
                            # checked here so a junk-typed field cannot
                            # reach the read loop
                            self._reply(400,
                                        {"error": "'gen' must be an "
                                                  "object"})
                            return
                        if not self._deadline_ok(
                                record.get("deadline_ns")):
                            self._reply(400,
                                        {"error": "deadline_ns must be "
                                                  "numeric"})
                            return
                        # engine-derived bookkeeping, never client input
                        record.pop("wire_bytes", None)
                        record.pop("wire_fmt", None)
                        # results are keyed by the queue rid (the uri):
                        # coerce to str so InProc dict lookups from
                        # GET /v1/result/<uri> find what the engine wrote
                        record["uri"] = str(record["uri"])
                        record.setdefault("trace_id", trace_id)
                        trace_id = record["trace_id"]
                        # the gateway is the trust edge for the span
                        # context: overwrite whatever the remote client
                        # sent (a junk ts would skew queue-wait; a forged
                        # parent would mis-thread the timeline)
                        record["trace_ctx"] = _mk_ctx(record)
                        # trust edge for identity: the header
                        # verdict overwrites any body-carried fields
                        record["tenant"] = rec_tenant
                        record["priority"] = rec_priority
                        if deadline_ns is not None:
                            record.setdefault("deadline_ns", deadline_ns)
                        uri, deadline_ns = record["uri"], \
                            record.get("deadline_ns")
                    if not self._uri_ok(str(uri)):
                        # FileQueue joins the uri into filesystem paths;
                        # a traversal-shaped uri from an untrusted remote
                        # client must never reach the backend
                        self._reply(400, {"error": "invalid uri"})
                        return
                    try:
                        serving.queue.xadd(record)
                    except QueueClosed as e:
                        # draining: mirror /readyz — stop sending here
                        self._reply(503, {"error": str(e)},
                                    extra_headers=(("Retry-After", "5"),))
                    except QueueFull as e:
                        # admission at the edge: shed the flood with
                        # backoff advice instead of growing the queue
                        # unboundedly
                        self._reply(429, {"error": str(e)},
                                    extra_headers=(("Retry-After", "1"),))
                    else:
                        doc = {"uri": uri, "trace_id": trace_id}
                        if deadline_ns is not None:
                            doc["deadline_ns"] = int(deadline_ns)
                        self._reply(200, doc)
                        # gateway span: this replica's ingest hop,
                        # parented under the LB root when one came in —
                        # its span id is the parent every engine stage
                        # span of this record hangs from.  trace_id here
                        # is the FINAL id (client-stamped wins), so the
                        # verdict matches what _mk_ctx propagated
                        if tracer is not None and _sampled_for(trace_id):
                            tracer.span(
                                "gateway", t0, time.monotonic(),
                                trace_id=trace_id, uri=uri,
                                span_id=gw_span,
                                parent_id=(inbound.span_id
                                           if inbound is not None
                                           else None),
                                attrs={"tenant": rec_tenant,
                                       "priority": rec_priority})
                finally:
                    gateway._observe("enqueue", t0, length)

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serving-probes", daemon=True)
        self._thread.start()
        logger.info(
            "serving http on http://%s:%d/{healthz,readyz,metrics%s}",
            self.host, self.port,
            ",v1/enqueue,v1/result" if gateway_on else "")
        return self

    def stop(self, timeout: float = 2.0) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
