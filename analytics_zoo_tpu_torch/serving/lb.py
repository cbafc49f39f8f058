"""Multi-replica load-balancing front door.

Every replica serves its own HTTP ingestion gateway on
``http_port + i`` — but clients had to pick a replica port by hand, and a
scale event (autoscaler or ``manager scale N``) changed the port set under
them.  ``LoadBalancer`` is the missing single-port front: it proxies

- ``POST /v1/enqueue``      — least-inflight pick over the READY replica
  gateways; a member that fails at the transport level (connection refused
  / reset / timeout — the SIGKILLed-replica shape) is marked out and the
  request retries on the next member, so a mid-stream replica death is
  **never** a client-visible failure.  503 from a member (draining) also
  re-routes; semantic statuses (200, 400, 411, 413, 429) pass through
  untouched — a full queue is full on every member alike.
- ``GET /v1/result/<uri>``  — results live in the SHARED queue backend, so
  any replica can answer; transport failures and gateway-side 5xx re-route
  with the remaining long-poll budget, 404 ("not ready") passes through.

plus its own ``/healthz`` / ``/readyz`` (ready = at least one ready
member) and ``/metrics`` (JSON or ``?format=prom``).

Membership is DYNAMIC: a ``member_source()`` callable returns the current
replica gateway URLs and is re-polled every probe tick, so the autoscaler
resizing the fleet (or an operator's ``manager scale N``) needs no client
reconfig — new replicas join the rotation as soon as their ``/readyz``
goes green, drained ones leave it.  ``manager_members(pidfile, ...)``
derives the URL set from the supervisor's scale file + per-replica
pidfiles; ``static_members([...])`` pins a fixed set.

Zero dependencies (stdlib ``ThreadingHTTPServer`` + ``urllib``), same as
the per-replica gateway it fronts.

CLI::

    python -m analytics_zoo_tpu_torch.serving.lb --port 8000 -c config.yaml \\
        [--pidfile cluster-serving.pid]      # members from the supervisor
    python -m analytics_zoo_tpu_torch.serving.lb --port 8000 \\
        --members http://127.0.0.1:8081,http://127.0.0.1:8082

(The manager runs one in-process with ``manager start --replicas N
--lb-port P``.)
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.common.observability import (MetricsRegistry,
                                                          SpanContext, Tracer,
                                                          new_trace_id,
                                                          trace_sampled)
from analytics_zoo_tpu_torch.serving.http import LONGPOLL_CAP_S, MAX_BODY_BYTES

logger = logging.getLogger(__name__)

# per-attempt transport timeout for enqueue proxying; result proxying uses
# the remaining long-poll budget + a small margin instead
ENQUEUE_TIMEOUT_S = 30.0
RESULT_MARGIN_S = 5.0


class _Transport(RuntimeError):
    """A member failed below HTTP (refused / reset / timeout): retry-able
    on another member, and grounds to mark the member unhealthy."""


class _Member:
    __slots__ = ("url", "inflight", "healthy", "fails", "lock")

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.inflight = 0
        self.healthy = False        # joins rotation on its first green probe
        self.fails = 0
        self.lock = threading.Lock()

    def mark(self, healthy: bool) -> None:
        with self.lock:
            flipped = healthy != self.healthy
            self.healthy = healthy
            self.fails = 0 if healthy else self.fails + 1
        if flipped:
            # incident flight recorder: member rotation flips are
            # exactly the "what was the front door seeing" evidence an
            # incident bundle needs (the supervisor drains this ring)
            try:
                from analytics_zoo_tpu_torch.common.observability \
                    import get_recorder
                get_recorder().record(
                    "lb_member_up" if healthy else "lb_member_down",
                    url=self.url)
            except Exception:  # noqa: BLE001 — diagnostics only
                pass


def static_members(urls: List[str]) -> Callable[[], List[str]]:
    urls = [u.rstrip("/") for u in urls]
    return lambda: list(urls)


def manager_members(pidfile: str, http_host: str = "127.0.0.1",
                    http_port: Optional[int] = None,
                    count: Optional[int] = None) -> Callable[[], List[str]]:
    """Member URLs from a ``manager start --replicas`` deployment: the
    supervisor's ``<pidfile>.replicas`` target names the slots, replica
    ``i`` serves its gateway on ``http_port + i``.  Slots whose replica
    pidfile is missing are still listed (the replica may be mid-spawn) —
    the readiness probe keeps them out of rotation until green."""

    def source() -> List[str]:
        if not http_port:
            return []
        n = count
        if n is None:
            from analytics_zoo_tpu_torch.serving.fleet import read_scale
            n = read_scale(pidfile)
        return [f"http://{http_host}:{http_port + i}" for i in range(n)]

    return source


class LoadBalancer:
    """One port in front of N replica gateways (see module docstring)."""

    def __init__(self, member_source: Callable[[], List[str]],
                 host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 1.0,
                 tracer: Optional[Tracer] = None,
                 trace_sample: float = 1.0,
                 span_spool: Optional[str] = None,
                 retry_budget: Optional[Dict] = None):
        self.member_source = member_source
        self.host = host
        self.port = port                    # actual port after start()
        self.registry = registry or MetricsRegistry()
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        # fleet tracing: the front door opens the ROOT span of
        # every proxied request and forwards the context as a W3C
        # `traceparent` header — the gateway continues it, the engine
        # parents its stage spans under it.  Head sampling uses the same
        # pure-function verdict as every other process; `span_spool`
        # names the jsonl file `drain_spans_to_spool()` appends to (the
        # manager supervisor / standalone CLI call it periodically).
        self.tracer = tracer or Tracer(replica_id="lb")
        try:
            self.trace_sample = min(max(float(trace_sample), 0.0), 1.0)
        except (TypeError, ValueError):
            self.trace_sample = 1.0
        self.span_spool = span_spool
        self._members: Dict[str, _Member] = {}
        self._members_lock = threading.Lock()
        self._rr = 0                        # least-inflight tie-breaker
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = self.registry
        self._m_requests = reg.counter(
            "lb_requests_total", "Front-door requests, by endpoint and "
            "status code", labels=("endpoint", "code"))
        self._m_retries = reg.counter(
            "lb_retries_total", "Requests re-routed to another member "
            "after a transport failure or 5xx", labels=("endpoint",))
        for ep in ("enqueue", "result"):
            self._m_retries.labels(endpoint=ep).inc(0)
        # retry budget: re-routes are amplification — under a
        # fleet-wide brownout every member answers 5xx and N members x M
        # clients of blind retries would triple the offered load exactly
        # when capacity is scarcest.  The budget caps the retry fraction
        # per window; a denied retry returns the member's LAST answer
        # (the truth: everyone is overloaded) instead of hammering on.
        self._retry_budget = None
        if retry_budget is not None and (
                retry_budget.get("enabled", True) if
                isinstance(retry_budget, dict) else bool(retry_budget)):
            from analytics_zoo_tpu_torch.common.resilience import RetryBudget
            cfg = retry_budget if isinstance(retry_budget, dict) else {}
            self._retry_budget = RetryBudget(
                ratio=float(cfg.get("ratio", 0.2)),
                min_retries=int(cfg.get("min_retries", 3)),
                window_s=float(cfg.get("window_s", 10.0)))
        self._m_budget_exhausted = reg.counter(
            "lb_retry_budget_exhausted_total", "Re-routes denied because "
            "the retry budget was spent")
        self._m_budget_exhausted.inc(0)
        self._m_latency = reg.histogram(
            "lb_request_seconds", "Front-door request latency, by endpoint",
            labels=("endpoint",))
        reg.gauge("lb_members_total", "Known replica gateways",
                  fn=lambda: float(len(self._snapshot_members())))
        reg.gauge("lb_members_ready", "Replica gateways in rotation",
                  fn=lambda: float(sum(
                      1 for m in self._snapshot_members() if m.healthy)))

    # -- membership -----------------------------------------------------------
    def _snapshot_members(self) -> List[_Member]:
        with self._members_lock:
            return list(self._members.values())

    def refresh_members(self) -> None:
        """Reconcile the member table with the source: new URLs join
        (out of rotation until probed green), vanished URLs leave."""
        try:
            urls = {u.rstrip("/") for u in (self.member_source() or [])}
        except Exception as e:  # noqa: BLE001 — a broken source must not
            logger.warning("lb: member source failed (%s: %s)",  # kill probes
                           type(e).__name__, e)
            return
        with self._members_lock:
            for url in urls - set(self._members):
                self._members[url] = _Member(url)
            for url in set(self._members) - urls:
                self._members.pop(url)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.probe_interval_s)

    def probe_once(self) -> None:
        """One membership refresh + readiness sweep (exposed for tests and
        for callers that want an immediate converge after a scale event)."""
        self.refresh_members()
        for member in self._snapshot_members():
            try:
                req = urllib.request.Request(member.url + "/readyz")
                with urllib.request.urlopen(
                        req, timeout=self.probe_timeout_s) as resp:
                    member.mark(resp.status == 200)
            except Exception:  # noqa: BLE001 — not ready / not reachable
                member.mark(False)

    def _pick(self, exclude) -> Optional[_Member]:
        """Least-inflight over ready members (round-robin tie-break).  When
        NO member is ready — probe data may be stale right after a mass
        restart — fall back to any un-excluded member so the request gets
        one real attempt instead of a blind 503."""
        members = [m for m in self._snapshot_members()
                   if m.url not in exclude]
        ready = [m for m in members if m.healthy]
        pool = ready or members
        if not pool:
            return None
        self._rr += 1
        return min(pool, key=lambda m: (m.inflight,
                                        hash((m.url, self._rr)) & 0xffff))

    # -- proxying -------------------------------------------------------------
    def _retry_allowed(self, endpoint: str) -> bool:
        """One re-route, if the retry budget has room.  Counts the
        retry when taken, the exhaustion when denied — a denied re-route
        surfaces the member's last answer instead of amplifying load."""
        if self._retry_budget is not None \
                and not self._retry_budget.allow_retry():
            self._m_budget_exhausted.inc()
            return False
        self._m_retries.labels(endpoint=endpoint).inc()
        return True

    @staticmethod
    def _forward(member: _Member, method: str, path_qs: str,
                 body: Optional[bytes], ctype: Optional[str],
                 timeout: float, headers=()):
        req = urllib.request.Request(member.url + path_qs, data=body,
                                     method=method)
        if ctype:
            req.add_header("Content-Type", ctype)
        for k, v in headers or ():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as e:
            # semantic HTTP answer (4xx/5xx with a body): NOT a transport
            # failure — the caller decides pass-through vs re-route
            try:
                payload = e.read()
            except OSError:
                payload = b""
            return e.code, payload, e.headers
        except Exception as e:  # noqa: BLE001 — refused/reset/timeout/DNS
            raise _Transport(f"{type(e).__name__}: {e}") from e

    def _proxy(self, endpoint: str, method: str, path: str, query: str,
               body: Optional[bytes], ctype: Optional[str],
               deadline: float, retry_503: bool, headers=()):
        """Try members until one answers: transport failures and (when
        ``retry_503``) 503s mark the member out and re-route; anything else
        passes through.  A result long-poll's ``timeout_s`` is REWRITTEN to
        the remaining budget on every attempt, so a re-route after a
        replica death long-polls the survivor for what is left — not the
        original budget past our own transport timeout.  Returns
        (status, body, headers, attempts)."""
        from urllib.parse import parse_qs, urlencode
        tried: set = set()
        last = None
        attempts = 0
        if self._retry_budget is not None:
            self._retry_budget.note_request()
        while True:
            member = self._pick(tried)
            if member is None:
                break
            tried.add(member.url)
            attempts += 1
            budget = deadline - time.monotonic()
            if budget <= 0:
                break                      # total budget spent re-routing
            qs = query
            if endpoint == "result":
                remaining = max(0.0, budget - RESULT_MARGIN_S)
                q = {k: v[-1] for k, v in parse_qs(query).items()}
                q["timeout_s"] = f"{remaining:.3f}"
                qs = urlencode(q)
                timeout = remaining + RESULT_MARGIN_S
            else:
                # the deadline bounds the WHOLE request across re-routes:
                # N wedged-but-listening members must cost at most one
                # enqueue budget total, not one each
                timeout = min(ENQUEUE_TIMEOUT_S, budget)
            path_qs = path + (f"?{qs}" if qs else "")
            with member.lock:
                member.inflight += 1
            try:
                status, payload, resp_headers = self._forward(
                    member, method, path_qs, body, ctype, timeout,
                    headers=headers)
            except _Transport as e:
                member.mark(False)
                logger.info("lb: member %s failed (%s); re-routing",
                            member.url, e)
                if not self._retry_allowed(endpoint):
                    break
                continue
            finally:
                with member.lock:
                    member.inflight -= 1
            if status >= 500 or (status == 503 and retry_503):
                # a 5xx (or a draining member's 503) may succeed elsewhere;
                # keep the answer in case every member says the same
                last = (status, payload, resp_headers, attempts)
                if status == 503:
                    member.mark(False)
                if not self._retry_allowed(endpoint):
                    break
                continue
            return status, payload, resp_headers, attempts
        if last is not None:
            return last
        return (503,
                json.dumps({"error": "no replica gateway available"})
                .encode(),
                {"Retry-After": "1"}, attempts)

    # -- distributed tracing ------------------------------------------
    _SNIFF_CAP = 262144                    # biggest reply body worth parsing

    @staticmethod
    def _parse_reply(payload: bytes) -> Optional[Dict]:
        """Gateway JSON reply body (enqueue ack / result) — how the front
        door joins its spans to a trace whose id may have been decided
        downstream (client-stamped frames win over the LB's root id), and
        how it tells terminal results from streaming partials.
        Best-effort: non-JSON / oversized bodies just yield None."""
        if not payload or len(payload) > LoadBalancer._SNIFF_CAP:
            return None
        try:
            doc = json.loads(payload)
        except ValueError:
            return None
        return doc if isinstance(doc, dict) else None

    @staticmethod
    def _sniff_trace_id(payload: bytes) -> Optional[str]:
        doc = LoadBalancer._parse_reply(payload)
        tid = doc.get("trace_id") if doc else None
        return tid if isinstance(tid, str) and tid else None

    def _record_root_span(self, stage: str, t0: float, ctx: SpanContext,
                          result, uri=None, inbound: bool = False,
                          parent_id=None, tenant=None,
                          priority=None) -> None:
        """The front door's span, IF this trace is sampled.  The verdict:
        an inbound traceparent's flag is authoritative (the upstream
        already decided — recording an explicitly-unsampled trace would
        leave orphan LB-only spans the rest of the fleet dropped);
        otherwise the fleet-pure hash of the trace's REAL id — sniffed
        from the reply when it differs from ours (client-stamped frame
        ids win downstream).  A reply with no sniffable id on a context
        we minted unsampled (header-less result polls) records nothing:
        a random id would mint a one-span orphan trace per poll."""
        if inbound and not ctx.sampled:
            return
        if not inbound and self.trace_sample <= 0.0 and not ctx.sampled:
            return                         # spans fully off: skip the parse
        status, payload, _, attempts = result
        doc = self._parse_reply(payload)
        if stage == "lb_result" and (doc is None or doc.get("partial")):
            # only a PARSED, terminal result records the lb_result leg: a
            # streaming partial at the long-poll deadline is not
            # terminal — a 20-poll token stream must not deposit one
            # bogus span per poll — and an unparseable/oversized body
            # cannot be told apart from one, so it records nothing rather
            # than flood (the gateway-side result_poll span still covers
            # the terminal fetch)
            return
        tid = doc.get("trace_id") if doc else None
        trace_id = tid if isinstance(tid, str) and tid else ctx.trace_id
        if not inbound:
            if trace_id == ctx.trace_id:
                if not ctx.sampled:
                    return
            elif not trace_sampled(trace_id, self.trace_sample):
                return
        attrs = {"code": int(status), "attempts": int(attempts)}
        # tenant attribution: the client-declared identity rides
        # the LB root span as-declared (the gateway's admission normalizes
        # it downstream — the LB is outside the trust edge)
        if isinstance(tenant, str) and tenant:
            attrs["tenant"] = tenant
        if isinstance(priority, str) and priority:
            attrs["priority"] = priority
        if attempts > 1:
            # the retry made visible: a re-routed request's root span says
            # so, next to the reclaim span the serving replica records
            attrs["rerouted"] = True
        # parent: the CALLER's span when it sent a traceparent — the
        # chain must not break at the fleet edge for clients carrying
        # their own tracing
        self.tracer.span(stage, t0, time.monotonic(), trace_id=trace_id,
                         uri=uri, span_id=ctx.span_id,
                         parent_id=parent_id, attrs=attrs)

    def drain_spans_to_spool(self) -> int:
        """Append every buffered span to ``span_spool`` (no-op without
        one).  Called by the manager supervisor loop and the standalone
        CLI — the LB's half of the fleet trace collection."""
        if not self.span_spool:
            return 0
        spans = self.tracer.drain_spans()
        if spans:
            from analytics_zoo_tpu_torch.serving import tracecollect
            tracecollect.append_spans(self.span_spool, spans, source="lb")
        return len(spans)

    # -- HTTP surface ---------------------------------------------------------
    def start(self) -> "LoadBalancer":
        lb = self

        class _Handler(BaseHTTPRequestHandler):
            timeout = 30

            def log_message(self, fmt, *args):  # noqa: A003
                logger.debug("lb: " + fmt, *args)

            def _reply(self, status: int, body: bytes,
                       ctype: str = "application/json",
                       extra=()) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, status: int, doc, extra=()) -> None:
                self._reply(status, json.dumps(doc).encode(), extra=extra)

            def _observe(self, endpoint: str, code: int,
                         t0: float) -> None:
                lb._m_requests.labels(endpoint=endpoint,
                                      code=str(code)).inc()
                lb._m_latency.labels(endpoint=endpoint).record(
                    time.monotonic() - t0)

            def _passthrough(self, result, endpoint: str,
                             t0: float) -> None:
                # headers is an http.client message or the plain dict from
                # _proxy's no-member fallback — both support .get
                status, payload, headers, attempts = result
                extra = []
                replica = headers.get("X-Replica-Id")
                if replica:
                    extra.append(("X-Replica-Id", str(replica)))
                retry_after = headers.get("Retry-After")
                if retry_after:
                    extra.append(("Retry-After", str(retry_after)))
                extra.append(("X-LB-Attempts", str(attempts)))
                ctype = headers.get("Content-Type") or "application/json"
                self._reply(status, payload, ctype=ctype, extra=extra)
                self._observe(endpoint, status, t0)

            def do_GET(self):  # noqa: N802
                from urllib.parse import parse_qs, urlsplit
                parts = urlsplit(self.path)
                try:
                    if parts.path == "/healthz":
                        members = lb._snapshot_members()
                        doc = {
                            "running": True,
                            "members": {m.url: {"ready": m.healthy,
                                                "inflight": m.inflight,
                                                "fails": m.fails}
                                        for m in members}}
                        if lb._retry_budget is not None:
                            doc["retry_budget"] = \
                                lb._retry_budget.snapshot()
                        self._reply_json(200, doc)
                    elif parts.path == "/readyz":
                        ready = [m.url for m in lb._snapshot_members()
                                 if m.healthy]
                        self._reply_json(
                            200 if ready else 503,
                            {"ready": bool(ready), "members": ready},
                            extra=(() if ready
                                   else (("Retry-After", "1"),)))
                    elif parts.path == "/metrics":
                        fmt = (parse_qs(parts.query).get("format")
                               or [None])[0]
                        if fmt == "prom" or (
                                fmt is None and "text/plain" in
                                (self.headers.get("Accept") or "")):
                            self._reply(
                                200,
                                lb.registry.to_prometheus().encode(),
                                ctype=MetricsRegistry.CONTENT_TYPE)
                        else:
                            self._reply_json(200, lb.registry.snapshot())
                    elif parts.path.startswith("/v1/result/"):
                        t0 = time.monotonic()
                        raw = (parse_qs(parts.query).get("timeout_s")
                               or ["0"])[0]
                        try:
                            budget = min(max(float(raw), 0.0),
                                         LONGPOLL_CAP_S)
                        except ValueError:
                            budget = 0.0
                        # result polls JOIN an existing trace (sniffed
                        # from the terminal reply) — continue an inbound
                        # context when one came in, otherwise let the
                        # sniffed trace_id's own sampling verdict decide
                        inbound = SpanContext.from_traceparent(
                            self.headers.get("traceparent"))
                        ctx = inbound.child() if inbound is not None \
                            else SpanContext(sampled=False)
                        result = lb._proxy(
                            "result", "GET", parts.path, parts.query,
                            None, None,
                            deadline=t0 + budget + RESULT_MARGIN_S,
                            retry_503=True,
                            headers=[("traceparent",
                                      ctx.to_traceparent())])
                        self._passthrough(result, "result", t0)
                        if result[0] == 200:
                            from urllib.parse import unquote
                            uri = unquote(
                                parts.path[len("/v1/result/"):])
                            lb._record_root_span(
                                "lb_result", t0, ctx, result, uri=uri,
                                inbound=inbound is not None,
                                parent_id=(inbound.span_id
                                           if inbound is not None
                                           else None),
                                tenant=self.headers.get("X-Tenant"),
                                priority=self.headers.get("X-Priority"))
                    else:
                        self._reply_json(
                            404, {"error": f"no route {parts.path}"})
                except Exception as e:  # noqa: BLE001 — front door answers
                    self._reply_json(500,
                                     {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):  # noqa: N802
                from urllib.parse import urlsplit
                parts = urlsplit(self.path)
                if parts.path != "/v1/enqueue":
                    self._reply_json(404,
                                     {"error": f"no route {parts.path}"})
                    return
                t0 = time.monotonic()
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        length = 0
                    if length <= 0:
                        self._reply_json(
                            411, {"error": "Content-Length required"})
                        self._observe("enqueue", 411, t0)
                        return
                    if length > MAX_BODY_BYTES:
                        self._reply_json(
                            413, {"error": f"body {length} bytes > cap "
                                           f"{MAX_BODY_BYTES}"})
                        self._observe("enqueue", 413, t0)
                        return
                    body = self.rfile.read(length)
                    # the ROOT span of the request's trace: mint
                    # trace + span id, decide sampling once (pure function
                    # of the id — the whole fleet agrees), forward the
                    # context so the gateway and engine parent under it
                    inbound = SpanContext.from_traceparent(
                        self.headers.get("traceparent"))
                    if inbound is not None:
                        ctx = inbound.child()
                    else:
                        tid = new_trace_id()
                        ctx = SpanContext(
                            tid, sampled=trace_sampled(
                                tid, lb.trace_sample))
                    fwd = [("traceparent", ctx.to_traceparent())]
                    # tenant identity + priority class ride to the
                    # gateway trust edge, where admission normalizes and
                    # stamps them — dropping them here would collapse every
                    # client into the anonymous default/batch lane
                    for h in ("X-Api-Key", "X-Tenant", "X-Priority"):
                        v = self.headers.get(h)
                        if v:
                            fwd.append((h, v))
                    result = lb._proxy(
                        "enqueue", "POST", parts.path, parts.query,
                        body, self.headers.get("Content-Type"),
                        deadline=t0 + ENQUEUE_TIMEOUT_S, retry_503=True,
                        headers=fwd)
                    self._passthrough(result, "enqueue", t0)
                    if result[0] == 200:
                        lb._record_root_span(
                            "lb_enqueue", t0, ctx, result,
                            inbound=inbound is not None,
                            parent_id=(inbound.span_id
                                       if inbound is not None
                                       else None),
                            tenant=self.headers.get("X-Tenant"),
                            priority=self.headers.get("X-Priority"))
                except Exception as e:  # noqa: BLE001
                    self._reply_json(500,
                                     {"error": f"{type(e).__name__}: {e}"})

        self._stop.clear()
        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serving-lb", daemon=True)
        self._thread.start()
        self.probe_once()                  # converge before first request
        self._probe_thread = threading.Thread(target=self._probe_loop,
                                              name="serving-lb-probe",
                                              daemon=True)
        self._probe_thread.start()
        logger.info("serving lb on http://%s:%d -> %d member(s)",
                    self.host, self.port, len(self._snapshot_members()))
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for t in (self._thread, self._probe_thread):
            if t is not None:
                t.join(timeout)
        self._thread = self._probe_thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="serving-lb")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--members", default=None,
                    help="comma-separated replica gateway URLs (fixed set)")
    ap.add_argument("--pidfile", default="cluster-serving.pid",
                    help="manager deployment: derive members from the "
                         "supervisor's scale file + config http_port")
    ap.add_argument("-c", "--config", default="config.yaml")
    ap.add_argument("--probe-interval", type=float, default=0.5)
    ap.add_argument("--span-spool", default=None, metavar="PATH",
                    help="append the front door's trace spans to this "
                         "jsonl spool (fleet trace collection; the "
                         "manager-run LB spools to <pidfile>.lb.spans."
                         "jsonl automatically)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="head-sampling rate for the root spans")
    args = ap.parse_args(argv)
    if args.members:
        source = static_members(
            [u for u in args.members.split(",") if u.strip()])
    else:
        from analytics_zoo_tpu_torch.serving.engine import ServingParams
        from analytics_zoo_tpu_torch.serving.manager import load_config
        try:
            params = ServingParams.from_dict(
                load_config(args.config).get("params", {}))
        except OSError:
            params = ServingParams()
        if not params.http_port:
            ap.error("config has no params.http_port; pass --members "
                     "explicitly")
        source = manager_members(args.pidfile, http_host=params.http_host,
                                 http_port=params.http_port)
    retry_budget = None
    try:
        from analytics_zoo_tpu_torch.serving.manager import load_config
        retry_budget = load_config(args.config).get("retry_budget")
    except OSError:
        pass
    lb = LoadBalancer(source, host=args.host, port=args.port,
                      probe_interval_s=args.probe_interval,
                      trace_sample=args.trace_sample,
                      span_spool=args.span_spool,
                      retry_budget=retry_budget).start()
    print(json.dumps({"lb": lb.url}), flush=True)
    try:
        while True:
            time.sleep(1.0)
            lb.drain_spans_to_spool()
    except KeyboardInterrupt:
        lb.drain_spans_to_spool()
        lb.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
