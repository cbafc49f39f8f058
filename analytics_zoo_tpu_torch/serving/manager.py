"""Cluster Serving lifecycle manager + config loader — the JAX package's
``serving/manager.py`` over the port's engine and ``InferenceModel``.

Reference parity: the `scripts/cluster-serving/` lifecycle scripts
(cluster-serving-init/start/stop/restart/shutdown), `ClusterServingHelper`
(serving/utils/ClusterServingHelper.scala:1-448 — config.yaml parsing with
model-type autodetect) and `ClusterServingManager.listenTermination`
(ClusterServingManager.scala:1-55).

config.yaml surface (scripts/cluster-serving/config.yaml template):

    model:
      path: /path/to/model            # autodetected: .npz zoo weights with
                                      # sibling topology.py, SavedModel dir,
                                      # .onnx, TorchScript .pt (the three
                                      # bridges are not ported and raise)
      type: onnx                      # optional override
      topology: /path/topology.py     # zoo: a python file defining
                                      # build_model() -> the port's model
                                      # (a JAX package topology file does
                                      # not load here)
      device: null                    # the torch device the replicas
                                      # serve on: null = cuda:0 (the load
                                      # raises without CUDA), cpu, cuda:1
    data:
      src: redis                      # redis | file:<dir> (cross-process)
      redis_host: localhost
      redis_port: 6379
      stream: image_stream
      max_depth: null                 # admission cap: xadd raises QueueFull
    params:
      batch_size: 4
      top_n: 5
      filter_threshold: null
      pipeline_depth: 2
      max_worker_restarts: 5            # resilience
      worker_backoff_s: 0.05
      breaker_threshold: 5
      breaker_cooldown_s: 0.5
      http_port: null                   # availability: /healthz,
      http_host: 127.0.0.1              # /readyz, /metrics probe endpoint
      gateway: true                     # ingestion gateway: serve
                                        # POST /v1/enqueue + GET
                                        # /v1/result/<uri> on the probe
                                        # port (binary frame or JSON,
                                        # 429/503 at the edge).  Under
                                        # --replicas the gateway rides each
                                        # replica (port http_port + i), so
                                        # ingest fails over with the
                                        # supervisor.  false = probe-only
                                        # port
      drain_s: null                     # graceful-drain budget on SIGTERM
      ready_queue_depth: null           # /readyz depth threshold
      max_batch: null                   # throughput: adaptive batcher
                                        # ceiling (null = batch_size)
      max_wait_ms: 5                    # coalescing budget for partial batches
      preprocess_workers: 1             # decode fan-out (>1 = thread pool)
      inflight_batches: 2               # async device pipeline depth
      trim_interval_s: 5                # amortized stream-trim period
      lease_s: 30                       # replicas: claimed-record
                                        # lease before another replica may
                                        # reclaim (> worst-case record time)
      reclaim_interval_s: null          # reclaim sweep period (null=lease/2)
      max_deliveries: 5                 # poison-pill parking: a
                                        # record delivered more than this
                                        # many times is parked to the
                                        # dead-letter queue
                                        # (max-deliveries-exceeded) instead
                                        # of looping through reclaim; <= 0
                                        # disables
      warmup: false                     # zero cold start: true =
                                        # warm every (bucket,
                                        # scales-variant) program at boot
                                        # (input spec inferred from the
                                        # topology; a generation lane's
                                        # decode quantum is captured as a
                                        # CUDA graph), or a spec dict
                                        # {shape: [d0, ...], dtype: <f4,
                                        # scales: auto|both|off,
                                        # max_batch: N}.  /readyz reports
                                        # `warming (k/n programs)` until
                                        # done; `start --replicas` runs
                                        # one throwaway pre-warm pass
                                        # first (see _prewarm)
      compile_cache_dir: null           # null or "off" only: XLA's
                                        # persistent compilation cache has
                                        # no counterpart here (the port
                                        # compiles nothing at serving
                                        # time); a path raises
      trace_sample: 1.0                 # distributed tracing:
                                        # head-sampling rate in [0, 1] —
                                        # the keep/drop verdict is a pure
                                        # function of the trace_id, so
                                        # LB/gateway/replicas agree
                                        # without coordination.  Error
                                        # spans always record.  0
                                        # disables span volume entirely
                                        # (metrics stay on).
      quantize: null                    # fused-dequant quantized predict
                                        #: null/off = float serve,
                                        # int8 | int4, or a dict
                                        # {bits: 8|4, group_size: 64,
                                        # percentile: 99.9, calib:
                                        # /path/batch.npy}.  `manager
                                        # warmup` quantizes BEFORE
                                        # exporting the weight store, so
                                        # replica forks serve quantized
                                        # from the mmap'd store.  int8
                                        # needs `calib` (activation
                                        # scales); int4 is weight-only
      flight_recorder: true             # incident flight recorder
                                        #: typed events (state
                                        # transitions, retunes, reclaims,
                                        # quarantines, warm-up phases,
                                        # scheduler boundaries) into a
                                        # bounded ring, drained to
                                        # <pidfile>.events.jsonl; false =
                                        # no-op hop
      recorder_ring: 4096               # ring size (events kept between
                                        # the manager's 1 s drains)
      profiling: true                   # POST /debug/profile?seconds=N
                                        # on the replica PROBE port (the
                                        # LB never proxies /debug); false
                                        # removes the route
      serving_slo: null                 # SLO attribution:
                                        # {latency_ms: 500, window_s: 60,
                                        # target: 0.99} judges every
                                        # completed record, attributes
                                        # each violation to its dominant
                                        # stage
                                        # (serving_slo_violations_total)
                                        # and drives the windowed
                                        # serving_slo_burn_rate gauge
    autoscaler:                         # closed-loop autoscaling,
      slo_p99_ms: 500                   # used with `start --replicas N
      min_replicas: 1                   # --autoscale`; every
      max_replicas: 8                   # AutoscalerParams field is accepted
      dwell_up_s: 2                     # (serving/autoscaler.py)
      dwell_down_s: 10
      scale_down_cooldown_s: 30
      max_step: 2
      sharding: off                     # off only: multi-GPU serving is
      mesh_shape: null                  # not ported (ROADMAP queue 1,
                                        # item 7's second part); other
                                        # values raise

CLI (used by scripts/cluster-serving/*.sh):
    python -m analytics_zoo_tpu_torch.serving.manager start  [-c config.yaml]
        [--replicas N]                 # N serving replica processes over the
        # SHARED queue (file/redis), supervised: a crashed replica is
        # respawned, its orphaned in-flight records reclaimed by survivors.
        # Replica i gets pidfile <pidfile>.r<i> (+ its own health snapshot)
        # and params.http_port + i when a probe port is configured.
        [--autoscale]                  # run the closed-loop
        # autoscaler in the supervisor — fleet signals from the per-replica
        # health docs, topology through the scale file (same path as
        # `manager scale N`), fast knob nudges through <pidfile>.knobs.json
        # (each replica polls + ClusterServing.retune()s), controller
        # metrics snapshotted to <pidfile>.autoscaler.json.  Tuned by the
        # config's `autoscaler:` section.
        [--lb-port P]                  # single-port load-balancing
        # front door (serving/lb.py) in the supervisor: proxies
        # /v1/enqueue + /v1/result across the live replica gateways with
        # least-inflight pick + /readyz health-out, tracking membership as
        # the fleet resizes — clients never see a scale event.
    python -m analytics_zoo_tpu_torch.serving.manager scale N
        # resize a running --replicas supervisor to N replicas (scale-up
        # spawns, scale-down SIGTERMs the highest-numbered replicas, which
        # drain gracefully per params.drain_s)
    python -m analytics_zoo_tpu_torch.serving.manager stop|status|restart
    python -m analytics_zoo_tpu_torch.serving.manager health   # worker/breaker/
        # dead-letter state from the daemon's <pidfile>.health.json snapshot
    python -m analytics_zoo_tpu_torch.serving.manager replay [--filter SUBSTR]
        # re-enqueue quarantined records after a fix (dead-letter replay)
    python -m analytics_zoo_tpu_torch.serving.manager metrics [--prom]
        # live metrics snapshot: GET the daemon's /metrics endpoint when
        # params.http_port is configured (--prom asks for the Prometheus
        # text exposition), else derive the same JSON document from the
        # health.json snapshot
    python -m analytics_zoo_tpu_torch.serving.manager warmup [-c config.yaml]
        # zero cold start: one throwaway pass that persists the
        # deployment's warm state next to the pidfile — the mmap weight
        # store (<pidfile>.weights, np.load(mmap_mode="r") at every
        # replica boot, page cache shared host-wide; quantized first when
        # params.quantize is set) and, on the card, the kernel libraries
        # under build/ (the warm pass launches every kernel of the
        # deployment's path, so a replica runs no nvcc).  `start
        # --replicas` runs this implicitly when params.warmup is set
        # (skip: --no-prewarm).  CUDA graphs do not outlive a process:
        # each replica still captures its own in its own warm-up.
    python -m analytics_zoo_tpu_torch.serving.manager metrics --all-replicas
        [--prom]
        # ONE fleet-wide snapshot summed across the per-replica
        # registries (HTTP scrape per replica, health.json fallback) — the
        # same aggregation the autoscaler consumes (serving/fleet.py).
        # --prom merges the per-replica text expositions (counters and
        # histogram series sum; shared-queue gauges take the max) and
        # appends the controller's own exposition when the autoscaler is
        # running, plus the LB front door's own series from
        # <pidfile>.lb.json.
    python -m analytics_zoo_tpu_torch.serving.manager incident
        [--list | --show [bundle] [--last N]]
        # incident forensics.  Bare `incident` snapshots a
        # self-contained bundle NOW (works live or post-mortem) into
        # <pidfile>.incidents/<ts>/: every process's flight-recorder
        # event spool + trace spools + health snapshots + autoscaler
        # decision log + LB telemetry + knobs/scale files.  The
        # supervisor auto-captures on replica crash and on SLO-burn
        # threshold (config `incident:` section).  --list enumerates
        # bundles; --show renders one merged cross-process timeline
        # (recorder events + trace spans, clock-normalized).
    python -m analytics_zoo_tpu_torch.serving.manager profile [replica]
        [--seconds S]
        # on-demand device profiling: POST /debug/profile on the
        # replica's probe port; a torch.profiler trace (trace.json, the
        # card's kernels included) lands under <pidfile>.profiles/<ts>/
        # (open with Perfetto).
    python -m analytics_zoo_tpu_torch.serving.manager trace <trace_id>
    python -m analytics_zoo_tpu_torch.serving.manager trace --slowest N
    python -m analytics_zoo_tpu_torch.serving.manager trace --chrome fleet.json
        # fleet-wide trace reconstruction.  Every process spools
        # its drained spans next to its health snapshot
        # (<pidfile>.rN.spans.jsonl per replica, <pidfile>.lb.spans.jsonl
        # for the front door); `trace <id>` merges them — monotonic clocks
        # normalized per process — and prints one request's cross-process
        # timeline (lb -> gateway -> queue-wait -> preprocess -> predict
        # -> write -> result-poll, parented spans, untracked gaps,
        # errors).  --slowest ranks traces by fleet e2e; --chrome exports
        # the merged timeline with one Perfetto track per process.
    python -m analytics_zoo_tpu_torch.serving.manager usage [--by model]
        # the usage journals' rollup by tenant (or model).

Forks and CUDA.  The supervisor forks its replicas, and a process that
has initialised CUDA cannot use it in a forked child.  So the supervisor,
and everything it imports, calls no CUDA function (not
``torch.cuda.is_available()``, which initialises CUDA, nor
``common/context.resolve_device``, nor a kernel build); each replica
resolves ``model.device`` after the fork.  Work that needs the card
before the replicas exist — the pre-warm, ``publish`` — runs in a
subprocess.  A process with CUDA live (a test, ``chip_smoke.py``) starts
the manager as a subprocess, never in a fork of itself.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from typing import Optional

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                    ServingParams)

PIDFILE = "cluster-serving.pid"


def load_config(path: str) -> dict:
    try:
        import yaml
        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        # minimal fallback parser for the flat 2-level template above
        cfg: dict = {}
        section = None
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].rstrip()
                if not line.strip():
                    continue
                if not line.startswith(" "):
                    section = line.strip().rstrip(":")
                    cfg[section] = {}
                else:
                    k, _, v = line.strip().partition(":")
                    v = v.strip()
                    if v in ("null", ""):
                        val = None
                    else:
                        try:
                            val = int(v)
                        except ValueError:
                            try:
                                val = float(v)
                            except ValueError:
                                val = v
                    cfg[section][k.strip()] = val
        return cfg


def detect_model_type(path: str) -> str:
    """ClusterServingHelper's model-type autodetect analog."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "saved_model.pb")):
            return "tensorflow"
        raise ValueError(f"cannot autodetect model type for dir {path}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".onnx":
        return "onnx"
    if ext in (".pt", ".pth", ".ts"):
        return "pytorch"
    if ext == ".npz":
        return "zoo"
    raise ValueError(f"cannot autodetect model type for {path}")


def load_model(cfg: dict,
               weight_store: Optional[str] = None) -> InferenceModel:
    """Build the deployment's InferenceModel on ``model.device`` (None:
    ``cuda:0``, which raises without CUDA).  ``weight_store``:
    when the per-deployment mmap store exists (``manager warmup`` exports
    it next to the pidfile), zoo weights restore from it —
    ``np.load(mmap_mode="r")`` per leaf, so N replicas on one host share
    the page cache instead of each inflating its own `.npz` copy.  The
    topology file's ``build_model()`` builds the port's model."""
    mcfg = cfg.get("model", {})
    path = mcfg.get("path")
    if not path:
        raise ValueError("config.yaml: model.path is required")
    mtype = mcfg.get("type") or detect_model_type(path)
    im = InferenceModel(device=mcfg.get("device"))
    if mtype == "tensorflow":
        return im.do_load_tensorflow(path)
    if mtype == "onnx":
        return im.do_load_onnx(path)
    if mtype == "pytorch":
        return im.do_load_pytorch(path)
    if mtype == "zoo":
        topo = mcfg.get("topology")
        if not topo:
            raise ValueError("zoo .npz weights need model.topology "
                             "(python file defining build_model())")
        scope: dict = {}
        with open(topo) as f:
            exec(compile(f.read(), topo, "exec"), scope)
        if weight_store:
            from analytics_zoo_tpu_torch.inference import weightstore
            if weightstore.is_store(weight_store):
                return im.do_load(scope["build_model"], weight_store)
        return im.do_load(scope["build_model"], path)
    raise ValueError(f"unknown model type {mtype!r}")


def build_queue(cfg: dict):
    dcfg = cfg.get("data", {})
    src = str(dcfg.get("src", "redis"))
    max_depth = dcfg.get("max_depth")
    if max_depth is not None:
        max_depth = int(max_depth)
    if src.startswith("file:"):
        from analytics_zoo_tpu_torch.serving.queues import FileQueue
        return FileQueue(src.split(":", 1)[1], max_depth=max_depth)
    if src == "inproc":
        from analytics_zoo_tpu_torch.serving.queues import InProcQueue
        return InProcQueue(max_depth=max_depth)
    from analytics_zoo_tpu_torch.serving.queues import RedisQueue
    return RedisQueue(host=dcfg.get("redis_host", "localhost"),
                      port=int(dcfg.get("redis_port", 6379)),
                      stream=dcfg.get("stream", "image_stream"),
                      max_depth=max_depth)


def serving_params(cfg: dict) -> ServingParams:
    # single shared parser (incl. the resilience knobs)
    return ServingParams.from_dict(cfg.get("params", {}))


def serve_from_config(config_path: str,
                      tensorboard_dir: Optional[str] = None,
                      replica_id: Optional[str] = None,
                      http_port_offset: int = 0,
                      cache_dir: Optional[str] = None,
                      weight_store: Optional[str] = None,
                      model_version: Optional[str] = None) -> ClusterServing:
    cfg = load_config(config_path)
    params = serving_params(cfg)
    if replica_id is not None:
        # supervisor-assigned identity wins over the config default
        # so every replica of one deployment is distinguishable
        params.replica_id = replica_id
    if model_version is not None:
        # rollout version identity: the supervisor's spawn spec
        # pins the registry version this replica serves; it rides the
        # health doc, /healthz and every result payload
        params.model_version = str(model_version)
    if params.http_port and http_port_offset:
        # replicas cannot share one probe port: replica i listens on
        # http_port + i (documented in the module docstring)
        params.http_port += http_port_offset
    if cache_dir:
        # the JAX manager's per-deployment XLA cache; _resolve_cache_dir
        # yields none here, and an explicit one raises as
        # ServingParams(compile_cache_dir=...) does
        ServingParams(compile_cache_dir=cache_dir)
    serving = ClusterServing(load_model(cfg, weight_store=weight_store),
                             build_queue(cfg),
                             params=params,
                             tensorboard_dir=tensorboard_dir)
    return serving


def _health_path(pidfile: str) -> str:
    return pidfile + ".health.json"


def _replica_pidfile(pidfile: str, index: int) -> str:
    return f"{pidfile}.r{index}"


def _scale_path(pidfile: str) -> str:
    """Desired replica count, written by `manager scale N` and polled by
    the supervisor — a file, not a signal, so the target survives a
    supervisor restart and is inspectable."""
    return pidfile + ".replicas"


def _knobs_path(pidfile: str) -> str:
    """Fast-tier knob targets: written by the supervisor's
    autoscaler, polled by every replica (same file-not-signal rationale as
    the scale file)."""
    return pidfile + ".knobs.json"


def _autoscaler_path(pidfile: str) -> str:
    return pidfile + ".autoscaler.json"


def _profiles_dir(pidfile: str) -> str:
    """On-demand torch.profiler traces: `manager profile <replica>`
    lands one timestamped trace dir per run in here."""
    return pidfile + ".profiles"


def _weights_dir(pidfile: str) -> str:
    """Per-deployment mmap'd weight store: `manager warmup`
    persists the params once, every replica boot maps the same pages."""
    return pidfile + ".weights"


def _registry_dir(pidfile: str) -> str:
    """Versioned model registry: `manager publish <version>`
    snapshots immutable version dirs under here; `manager rollout` moves
    the fleet between them one replica at a time."""
    return pidfile + ".registry"


def _version_store(pidfile: str, version: str,
                   model_name: str = "default") -> str:
    """The weight store a replica assigned to ``version`` must load —
    verified FIRST: a truncated/corrupt version must fail the spawn
    loudly (the supervisor's crash accounting then rolls back), never
    serve garbage weights."""
    from analytics_zoo_tpu_torch.serving import registry as _registry
    problems = _registry.verify(_registry_dir(pidfile), version,
                                model=model_name)
    if problems:
        raise _registry.RegistryError(
            f"version {version!r} failed integrity verification: "
            + "; ".join(problems[:3]))
    return _registry.store_path(_registry_dir(pidfile), version,
                                model=model_name)


def _model_name(cfg: dict) -> str:
    name = (cfg.get("model") or {}).get("name")
    return str(name) if name else "default"


def _jsonable(v):
    """Best-effort JSON projection for registry metadata (warm-up
    manifest entries carry dtypes/tuples json.dump chokes on)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def _resolve_cache_dir(params: ServingParams, pidfile: str):
    """The JAX manager's per-deployment XLA compilation cache
    (``<pidfile>.xla_cache``).  None here: the port compiles nothing at
    serving time (kernel libraries are built once under ``build/`` and
    CUDA graphs are captured per process), and ``ServingParams`` accepts
    no cache path."""
    return None


def _warm_pass(im: InferenceModel, params: ServingParams) -> dict:
    """`manager warmup`'s warm pass over the loaded model: a generation
    deployment's scheduler programs (``ContinuousBatcher.warm`` on a
    batcher of the deployment's ``generation`` parameters), else the
    predict manifest of ``params.warmup`` (``aot.warm_up``).  On the card
    it launches every kernel of the deployment's path, which builds the
    kernel libraries the replicas then load.  Returns the pass's stats."""
    from analytics_zoo_tpu_torch.inference import aot
    if params.generation is not None:
        from analytics_zoo_tpu_torch.serving.generate import (
            ContinuousBatcher, GenerationParams)
        return ContinuousBatcher(
            im, GenerationParams.from_dict(params.generation)).warm()
    return aot.warm_up(im, aot.resolve_manifest(
        im, params.warmup if params.warmup else True))


def _kernels_built() -> list:
    """The kernel libraries this process compiled with ``nvcc`` (none
    when every one it loaded was already built under ``build/``)."""
    from analytics_zoo_tpu_torch.ops import _build
    return sorted(_build.BUILD_SECONDS)


def _write_health(serving, path: str) -> None:
    """Atomic health snapshot (ClusterServing.health()) next to the pidfile —
    the `status`/`health` CLI actions read it from outside the daemon."""
    tmp = path + ".tmp"
    try:
        snapshot = dict(serving.health(), ts=time.time())
        with open(tmp, "w") as f:
            json.dump(snapshot, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _lb_path(pidfile: str) -> str:
    """LB telemetry snapshot: the supervisor persists the front
    door's registry snapshot + Prometheus exposition here each pass, so
    ``manager metrics --all-replicas`` can include the LB's own series
    (lb_requests_total / lb_retries_total were otherwise invisible to the
    fleet doc)."""
    return pidfile + ".lb.json"


def _drain_spans(serving, pidfile: str) -> None:
    """Span spool hop: drain this replica's tracer ring into the
    per-replica spool next to the health snapshot.  Best-effort — a full
    disk must not kill the serving loop."""
    try:
        from analytics_zoo_tpu_torch.serving import tracecollect
        spans = serving.tracer.drain_spans()
        if spans:
            tracecollect.append_spans(tracecollect.spool_path(pidfile),
                                      spans, source=serving.replica_id)
    except Exception:  # noqa: BLE001 — tracing is never load-bearing
        pass


def _drain_events(pidfile: str, source=None) -> None:
    """Flight-recorder spool hop: drain this PROCESS's event ring
    into ``<pidfile>.events.jsonl`` — same rotation/clock contract as the
    span spools, so `manager incident`/`trace` merge both onto one
    timeline.  Runs in replicas (engine/gateway/compile events) AND the
    supervisor (autoscaler/LB/lifecycle events)."""
    try:
        from analytics_zoo_tpu_torch.common.observability import get_recorder
        from analytics_zoo_tpu_torch.serving import tracecollect
        events = get_recorder().drain_events()
        if events:
            tracecollect.append_events(tracecollect.events_path(pidfile),
                                       events, source=source)
    except Exception:  # noqa: BLE001 — forensics is never load-bearing
        pass


def _drain_usage(serving, pidfile: str) -> None:
    """Usage journal hop: drain this replica's per-interval
    usage deltas into ``<pidfile>.usage.jsonl`` — same rotation/clock
    contract as the span/event spools, rolled up by `manager usage`.
    Best-effort: metering must never be load-bearing."""
    try:
        from analytics_zoo_tpu_torch.serving import tracecollect
        records = serving.drain_usage()
        if records:
            tracecollect.append_usage(tracecollect.usage_path(pidfile),
                                      records, source=serving.replica_id)
    except Exception:  # noqa: BLE001 — metering is never load-bearing
        pass


def _run_foreground(config_path: str, pidfile: str,
                    replica_id: Optional[str] = None,
                    http_port_offset: int = 0,
                    knobs_path: Optional[str] = None,
                    base_pidfile: Optional[str] = None,
                    model_version: Optional[str] = None):
    """One serving process: load the model (on ``model.device``), serve,
    and once a second write the health snapshot, drain the span / event /
    usage spools and apply the knobs file.  SIGTERM (and SIGINT) drains
    with admission closed and exits; SIGUSR1 retires: it drains WITHOUT
    closing the shared queue's admission.

    The handlers only note the signal; this loop runs the drain on the
    main thread between its passes, never inside a handler, so a signal
    that lands while the main thread holds an engine lock (a health
    snapshot, a retune) cannot deadlock against the drain, and the
    decode thread stops at a boundary of its own loop (a CUDA graph
    replay is never cut off mid-flight)."""
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    # every replica of one deployment shares the BASE pidfile's weight
    # store (replica pidfiles are `<base>.rN`)
    base = base_pidfile or pidfile
    cfg0 = load_config(config_path)
    # rollout: a version-assigned replica loads the REGISTRY's
    # immutable snapshot for that version, integrity-verified first — a
    # corrupt version fails the spawn loudly instead of serving garbage
    weight_store = (_version_store(base, model_version, _model_name(cfg0))
                    if model_version else _weights_dir(base))
    serving = serve_from_config(config_path, replica_id=replica_id,
                                http_port_offset=http_port_offset,
                                weight_store=weight_store,
                                model_version=model_version)
    # on-demand profiling: traces land next to the deployment's
    # other artifacts, shared across the replicas of one base pidfile
    serving.profile_dir = _profiles_dir(base)
    # generation continuity: checkpoints spool next to THIS
    # replica's pidfile (per-replica ownership, like span/event spools) —
    # the engine writes it directly at step boundaries, because the
    # manager's 1 s drain cadence is far too slow for crash durability
    from analytics_zoo_tpu_torch.serving import tracecollect as _tc
    serving.snapshot_path = _tc.gensnap_path(pidfile)
    health_path = _health_path(pidfile)
    if knobs_path is None:
        knobs_path = _knobs_path(pidfile)
    knobs_seen = 0
    signals: list = []

    def _note(signum, frame):
        signals.append(signum)

    signal.signal(signal.SIGTERM, _note)
    signal.signal(signal.SIGINT, _note)
    retire_sig = getattr(signal, "SIGUSR1", None)
    if retire_sig is not None:
        signal.signal(retire_sig, _note)
    serving.start()
    while not signals:
        _write_health(serving, health_path)
        # fleet tracing: the replica's export hop — drained spans
        # land in <pidfile>.spans.jsonl, merged fleet-wide by
        # `manager trace`
        _drain_spans(serving, pidfile)
        # flight recorder: same hop for the event ring
        _drain_events(pidfile, source=serving.replica_id)
        # usage metering: same hop for the usage journal
        _drain_usage(serving, pidfile)
        # live knob nudges (autoscaler fast tier): the supervisor's
        # autoscaler writes <base pidfile>.knobs.json; every replica polls
        # it once a second and applies via retune() — validated, and taken
        # up at the engine's next batch boundary
        try:
            st = os.stat(knobs_path)
            if st.st_mtime_ns != knobs_seen:
                knobs_seen = st.st_mtime_ns
                with open(knobs_path) as f:
                    knobs = json.load(f)
                if isinstance(knobs, dict):
                    serving.retune(**{
                        k: knobs[k] for k in
                        ("max_batch", "max_wait_ms",
                         "preprocess_workers", "inflight_batches")
                        if k in knobs})
        except (OSError, ValueError, TypeError):
            pass                           # no/garbled knobs file: keep as-is
        for _ in range(10):                # a pass a second; a signal ends
            if signals:                    # the wait within 0.1 s
                break
            time.sleep(0.1)
    if signals[0] == retire_sig:
        # scale-down decommission: flush in-flight work and exit WITHOUT
        # closing the shared queue's admission — one retiring replica
        # must not cut off ingest for the survivors
        serving.shutdown(drain_s=serving.params.drain_s,
                         close_admission=False)
    else:
        # ClusterServingManager.listenTermination analog: graceful drain
        # (admission closed, /readyz flips to draining, in-flight results
        # flushed within params.drain_s) + exit
        serving.shutdown(drain_s=serving.params.drain_s)
    # spans recorded during the drain (final writes, sheds) flush to the
    # spool last — the spool survives the process for post-mortem
    # `manager trace`; the usage journal survives `manager stop`, so the
    # final interval's usage is not lost to billing
    _drain_spans(serving, pidfile)
    _drain_events(pidfile, source=serving.replica_id)
    _drain_usage(serving, pidfile)
    for p in (pidfile, health_path):
        try:
            os.unlink(p)
        except OSError:
            pass
    sys.exit(0)


def _prewarm(config_path: str, pidfile: str,
             timeout_s: float = 900.0,
             version: Optional[str] = None) -> Optional[dict]:
    """One throwaway warm-up pass BEFORE any replica forks: a
    subprocess (never a fork — the supervisor must stay CUDA-free so its
    children fork clean) runs `manager warmup`.  What it buys the
    replicas spawned afterwards (every future autoscaler scale-up
    included): the mmap weight store — each boot maps it, quantized
    already when ``params.quantize`` is set, instead of reading the
    ``.npz`` (and quantizing) for itself — and, on the card, the kernel
    libraries under ``build/``, which its warm pass builds, so no replica
    runs ``nvcc``.  It does not save the replicas their own warm-up: a
    CUDA graph does not outlive its process, so each replica captures
    its own.  Failure is logged, not fatal: replicas then load the
    ``.npz`` and build what they need themselves.

    With ``version`` (rollout), the pass loads the REGISTRY snapshot for
    that version instead of re-exporting — run before the canary takes
    traffic, so a version that does not load or warm is caught before
    any replica is retired onto it."""
    import subprocess
    cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.manager",
           "warmup", "-c", config_path, "--pidfile", pidfile]
    if version:
        cmd += ["--version", version]
    try:
        out = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout_s)
        doc = None
        for line in (out.stdout or "").splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    doc = json.loads(line)
                except ValueError:
                    pass
        if out.returncode != 0:
            print(json.dumps({"event": "prewarm failed",
                              "rc": out.returncode,
                              "stderr": (out.stderr or "")[-500:]}),
                  file=sys.stderr, flush=True)
            return None
        print(json.dumps({"event": "prewarm done", "warmup": doc}),
              file=sys.stderr, flush=True)
        return doc
    except Exception as e:  # noqa: BLE001 — prewarm is best-effort
        print(json.dumps({"event": "prewarm failed",
                          "error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr, flush=True)
        return None


def _run_supervisor(config_path: str, pidfile: str, replicas: int,
                    autoscale: bool = False,
                    lb_port: Optional[int] = None,
                    prewarm: bool = True):
    """Replica supervisor: fork one serving process per
    replica over the SHARED queue, monitor them, respawn crashed ones (a
    SIGKILLed replica's orphaned records are reclaimed by the survivors
    while the respawn happens), and track the desired count in
    `<pidfile>.replicas` so `manager scale N` can resize a live deployment.
    SIGTERM forwards to every replica (each drains per params.drain_s) and
    then exits.

    With ``autoscale`` the closed-loop controller runs here too —
    fleet signals from the per-replica health docs, topology through the
    SAME scale file `manager scale N` writes (the supervisor poll loop is
    the actuator either way), knob nudges through `<pidfile>.knobs.json`,
    controller metrics snapshotted to `<pidfile>.autoscaler.json` each
    pass.  With ``lb_port`` the single-port load-balancing front door
    (serving/lb.py) serves next to the supervisor, tracking membership as
    the fleet resizes."""
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    scale_path = _scale_path(pidfile)
    with open(scale_path, "w") as f:
        f.write(str(replicas))
    children: dict = {}                    # index -> pid
    last_spawn: dict = {}                  # index -> monotonic ts (backoff)
    stopping: set = set()                  # indices already SIGTERMed

    cfg = load_config(config_path)
    params = serving_params(cfg)
    # incident auto-capture: config `incident:` section —
    # `burn_threshold` snapshots a bundle when any replica's SLO burn
    # rate crosses it, `on_crash` (default on) when a replica dies and
    # is respawned, `cooldown_s` bounds capture frequency, `max_bundles`
    # bounds disk.  Capture is supervisor-side file copying of drained
    # spools: the serving hot path never blocks.
    icfg = cfg.get("incident") if isinstance(cfg.get("incident"), dict) \
        else {}
    inc_burn = icfg.get("burn_threshold")
    inc_burn = None if inc_burn is None else float(inc_burn)
    inc_on_crash = bool(icfg.get("on_crash", True))
    inc_cooldown = float(icfg.get("cooldown_s", 60.0))
    inc_max = int(icfg.get("max_bundles", 20))
    inc_last = {"t": -1e9}
    from analytics_zoo_tpu_torch.common.observability import get_recorder
    recorder = get_recorder()

    def _capture_incident(reason: str, meta=None, force=False):
        from analytics_zoo_tpu_torch.serving import incident as _incident
        now = time.monotonic()
        if not force and now - inc_last["t"] < inc_cooldown:
            return None
        inc_last["t"] = now
        # the bundle meta may itself carry a "reason" (the rollback
        # verdict) — the event's positional `reason` wins, drop the
        # duplicate instead of TypeError-ing the capture away
        extra = {k: v for k, v in (meta or {}).items() if k != "reason"}
        recorder.record("incident", reason=reason, **extra)
        # flush the supervisor's own ring first so the bundle carries the
        # trigger event itself (replica spools were drained by their own
        # 1 s loops — capture reads files, never the hot path)
        _drain_events(pidfile, source="supervisor")
        bundle = _incident.capture(pidfile, reason, meta=meta,
                                   max_bundles=inc_max)
        if bundle:
            print(json.dumps({"event": "incident captured",
                              "reason": reason, "bundle": bundle}),
                  file=sys.stderr, flush=True)
        return bundle

    # zero-drop rollout: versioned-registry state.  The rollout
    # STATE file persists the per-replica version assignments — the
    # respawn pin (satellite bugfix: a replica that crashes mid-rollout
    # respawns at its ASSIGNED version, incumbent or canary, never
    # blindly at `latest`) — and survives a supervisor restart.
    from analytics_zoo_tpu_torch.serving import registry as _registry
    from analytics_zoo_tpu_torch.serving import rollout as _rollout
    rparams = _rollout.RolloutParams.from_dict(cfg.get("rollout"))
    model_name = _model_name(cfg)
    reg_dir = _registry_dir(pidfile)
    rst = _rollout.load_state(pidfile)
    assigned: dict = rst.get("assignments") or {}
    if rst.get("base") is None:
        # fresh deployment: serve the registry's latest when one is
        # published; an unversioned deployment (no registry) keeps the
        # plain config/weight-store path exactly as without a registry
        rst["base"] = _registry.latest(reg_dir, model_name)
    rolling: set = set()        # indices being intentionally replaced
    rollout_meta = {"canary_crashes": 0, "t_phase": time.monotonic(),
                    "dwell_start": None, "replacing": None}

    def _assigned_version(index: int):
        return assigned.get(index, rst.get("base"))

    def _save_rollout():
        rst["assignments"] = assigned
        _rollout.save_state(pidfile, rst)

    _save_rollout()

    if prewarm and params.warmup:
        # export the deployment's weight store (and build the kernel
        # libraries) before the replicas fork, so they, and every
        # scale-up after them, boot from the mmap'd store
        _prewarm(config_path, pidfile, version=rst.get("base"))
    scaler = None
    balancer = None
    if autoscale:
        from analytics_zoo_tpu_torch.serving.autoscaler import (Autoscaler,
                                                                AutoscalerParams,
                                                                ManagerFleet)
        as_params = AutoscalerParams.from_dict(cfg.get("autoscaler") or {})
        fleet = ManagerFleet(pidfile, http_host=params.http_host,
                             http_port=params.http_port,
                             max_replicas=as_params.max_replicas)
        scaler = Autoscaler(fleet, params=as_params).start()
    if lb_port is not None:
        from analytics_zoo_tpu_torch.serving.lb import (LoadBalancer,
                                                        manager_members)
        from analytics_zoo_tpu_torch.serving.tracecollect import spool_path
        balancer = LoadBalancer(
            manager_members(pidfile, http_host=params.http_host,
                            http_port=params.http_port),
            host=params.http_host, port=lb_port,
            trace_sample=params.trace_sample,
            span_spool=spool_path(pidfile + ".lb"),
            retry_budget=cfg.get("retry_budget")).start()

    def _spawn(index: int):
        last_spawn[index] = time.monotonic()
        # rollout: the spawn spec pins the replica's ASSIGNED
        # version — during a rollout the canary respawns at the target
        # and every incumbent at the prior, so a crash mid-canary can
        # never silently promote (or demote) a replica
        version = _assigned_version(index)
        recorder.record("replica_spawn", index=index,
                        model_version=version)
        pid = os.fork()
        if pid == 0:
            # child: plain replica process with its own pidfile/health
            # snapshot, default signal disposition restored so the replica
            # installs its own graceful-drain SIGTERM handler
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.signal(signal.SIGINT, signal.SIG_DFL)
            # the fork copies the supervisor's process-wide flight-
            # recorder ring: clear it, or the child's 1 s drain would
            # re-spool the supervisor's undrained events (this very
            # spawn event included) misattributed to the replica
            get_recorder().clear()
            code = 0
            try:
                _run_foreground(config_path, _replica_pidfile(pidfile, index),
                                replica_id=f"replica-{index}",
                                http_port_offset=index,
                                knobs_path=_knobs_path(pidfile),
                                base_pidfile=pidfile,
                                model_version=version)
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 0
            except BaseException:  # noqa: BLE001 — a failed boot: say why
                import traceback
                traceback.print_exc()
                code = 1
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        children[index] = pid

    retire_sig = getattr(signal, "SIGUSR1", signal.SIGTERM)

    def _read_rhealth(index: int):
        try:
            with open(_health_path(_replica_pidfile(pidfile, index))) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    def _replace(index: int, version):
        """Move one replica slot onto ``version``: pin the assignment
        (respawn-safe), then SIGUSR1-retire the old process — it drains
        with shared-queue admission OPEN, its leases cover in-flight
        records, and the reap/spawn passes bring the slot back up at the
        new version.  The LB health-outs the retiring gateway, so the
        swap is client-invisible."""
        assigned[index] = version
        _save_rollout()
        recorder.record("rollout_replace", index=index, version=version)
        pid = children.get(index)
        if pid:
            rolling.add(index)
            try:
                os.kill(pid, retire_sig)
            except OSError:
                pass

    def _begin_rollback(reason: str):
        target, prior = rst.get("target"), rst.get("base")
        recorder.record("rollback", target=target, prior=prior,
                        reason=str(reason)[:200])
        print(json.dumps({"event": "rollout rollback",
                          "from_version": target, "to_version": prior,
                          "reason": reason}), file=sys.stderr, flush=True)
        # the rollback IS the incident: bundle the evidence BEFORE the
        # reverse restart rotates it, stamped with both versions.
        # force=True — a crash capture moments earlier must not suppress
        # the rollback's own forensics behind the cooldown
        _capture_incident(
            f"rollout-rollback {target} -> {prior or 'unversioned'}",
            meta={"from_version": target, "to_version": prior,
                  "reason": str(reason)[:500],
                  "phase": rst.get("phase")},
            force=True)
        rst["phase"] = "rollback"
        rst["reason"] = str(reason)
        rollout_meta["t_phase"] = time.monotonic()
        rollout_meta["replacing"] = None
        rollout_meta["dwell_start"] = None
        _save_rollout()

    def _rollout_tick(desired: int):
        """One pass of the rollout state machine (idle -> canary ->
        rolling -> idle, or -> rollback -> idle), driven off the same
        per-replica health snapshots the incident triggers read."""
        now = time.monotonic()
        phase = rst.get("phase", "idle")
        if phase == "idle":
            req = _rollout.read_request(pidfile)
            if not req or not req.get("target"):
                return
            if float(req.get("ts") or 0) <= float(rst.get("req_ts") or 0):
                return                     # request already processed
            target = str(req["target"])
            rst["req_ts"] = req.get("ts")
            if target == rst.get("base"):
                print(json.dumps({"event": "rollout no-op",
                                  "target": target,
                                  "detail": "fleet already at target"}),
                      file=sys.stderr, flush=True)
                _save_rollout()
                return
            try:
                problems = _registry.verify(reg_dir, target,
                                            model=model_name)
            except Exception as e:  # noqa: BLE001 — registry unreadable
                problems = [f"{type(e).__name__}: {e}"]
            if problems:
                # a truncated/corrupt version is rejected LOUDLY and the
                # previous version keeps serving — no replica is touched
                recorder.record("rollout_rejected", target=target,
                                problems=len(problems))
                rst["last_error"] = {"target": target,
                                     "problems": problems[:5]}
                _save_rollout()
                print(json.dumps({"event": "rollout rejected",
                                  "target": target,
                                  "problems": problems[:5]}),
                      file=sys.stderr, flush=True)
                return
            if rparams.prewarm and params.warmup:
                # load and warm the new version once before any replica
                # is retired onto it
                _prewarm(config_path, pidfile, version=target)
            rst.update(phase="canary", target=target, canary_index=0,
                       started=time.time(), reason=None, diverged=None)
            rollout_meta.update(canary_crashes=0, t_phase=now,
                                dwell_start=None, replacing=None)
            recorder.record("rollout_start", target=target,
                            prior=rst.get("base"))
            print(json.dumps({"event": "rollout start", "target": target,
                              "prior": rst.get("base")}),
                  file=sys.stderr, flush=True)
            _replace(0, target)
            return
        target = rst.get("target")
        if phase == "canary":
            idx = int(rst.get("canary_index") or 0)
            doc = _read_rhealth(idx)
            at_target = (doc is not None
                         and doc.get("model_version") == target
                         and idx in children and idx not in rolling)
            incumbents = []
            for i in range(desired):
                if i == idx:
                    continue
                d = _read_rhealth(i)
                if d is not None:
                    incumbents.append(d)
            reason = _rollout.judge(doc if at_target else None, incumbents,
                                    rparams,
                                    rollout_meta["canary_crashes"])
            if reason:
                if rparams.auto_rollback:
                    _begin_rollback(reason)
                    return
                if rst.get("diverged") != reason:
                    # rollback disabled (chaos A/B control arm): record
                    # the divergence verdict, keep rolling — the damage
                    # this causes is the measurement
                    rst["diverged"] = reason
                    recorder.record("rollout_diverged", target=target,
                                    reason=str(reason)[:200])
                    _save_rollout()
            if not at_target or not bool(
                    (doc.get("ready") or {}).get("ready")):
                if now - rollout_meta["t_phase"] > rparams.ready_timeout_s \
                        and rparams.auto_rollback:
                    _begin_rollback(
                        f"canary not ready at {target} within "
                        f"{rparams.ready_timeout_s:g}s")
                return
            if rollout_meta["dwell_start"] is None:
                rollout_meta["dwell_start"] = now
                recorder.record("canary_serving", index=idx,
                                target=target)
                return
            if now - rollout_meta["dwell_start"] >= rparams.canary_dwell_s:
                recorder.record("canary_pass", target=target,
                                dwell_s=round(
                                    now - rollout_meta["dwell_start"], 3))
                print(json.dumps({"event": "canary pass",
                                  "target": target}),
                      file=sys.stderr, flush=True)
                rst["phase"] = "rolling"
                rollout_meta["t_phase"] = now
                rollout_meta["replacing"] = None
                _save_rollout()
            return
        if phase == "rolling":
            r = rollout_meta["replacing"]
            if r is not None:
                doc = _read_rhealth(r)
                up = (doc is not None
                      and doc.get("model_version") == target
                      and bool((doc.get("ready") or {}).get("ready"))
                      and r in children and r not in rolling)
                if up:
                    rollout_meta["replacing"] = None
                    rollout_meta["t_phase"] = now
                elif now - rollout_meta["t_phase"] > \
                        rparams.ready_timeout_s:
                    if rparams.auto_rollback:
                        _begin_rollback(
                            f"replica {r} not ready at {target} within "
                            f"{rparams.ready_timeout_s:g}s")
                    return
                else:
                    return
            pending = [i for i in range(desired)
                       if _assigned_version(i) != target]
            if pending:
                # one at a time: the fleet is never more than one
                # replica short of desired capacity
                nxt = pending[0]
                rollout_meta["replacing"] = nxt
                rollout_meta["t_phase"] = now
                _replace(nxt, target)
                return
            rst["base"] = target
            assigned.clear()
            rst.update(phase="idle", target=None, reason=None)
            recorder.record("promote", version=target)
            print(json.dumps({"event": "promote", "version": target}),
                  file=sys.stderr, flush=True)
            _save_rollout()
            return
        if phase == "rollback":
            prior = rst.get("base")
            r = rollout_meta["replacing"]
            if r is not None:
                doc = _read_rhealth(r)
                home = (doc is not None
                        and doc.get("model_version") == prior
                        and r in children and r not in rolling)
                if home:
                    rollout_meta["replacing"] = None
                    rollout_meta["t_phase"] = now
                elif now - rollout_meta["t_phase"] > \
                        rparams.ready_timeout_s:
                    # never wedge the rollback on one slow slot — its
                    # assignment is already pinned to prior, the respawn
                    # loop keeps trying; move on
                    recorder.record("rollback_replica_timeout", index=r)
                    rollout_meta["replacing"] = None
                    rollout_meta["t_phase"] = now
                else:
                    return
            pending = [i for i in range(desired)
                       if _assigned_version(i) != prior]
            if pending:
                nxt = pending[0]
                rollout_meta["replacing"] = nxt
                rollout_meta["t_phase"] = now
                _replace(nxt, prior)
                return
            tgt = rst.get("target")
            assigned.clear()
            rst["last_rollback"] = {"target": tgt,
                                    "reason": rst.get("reason"),
                                    "finished": time.time()}
            rst.update(phase="idle", target=None)
            recorder.record("rollback_done", target=tgt, prior=prior)
            print(json.dumps({"event": "rollback done", "target": tgt,
                              "prior": prior}),
                  file=sys.stderr, flush=True)
            _save_rollout()
            return

    def _terminate():
        for pid in children.values():
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + 60        # replicas drain per their config
        for pid in children.values():
            while time.time() < deadline:
                try:
                    if os.waitpid(pid, os.WNOHANG)[0]:
                        break
                except ChildProcessError:
                    break
                time.sleep(0.1)
        if scaler is not None:
            scaler.stop()
        if balancer is not None:
            try:
                balancer.drain_spans_to_spool()
            except Exception:  # noqa: BLE001
                pass
            balancer.stop()
        for index in list(children):
            for p in (_replica_pidfile(pidfile, index),
                      _health_path(_replica_pidfile(pidfile, index))):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        for p in (pidfile, scale_path, _knobs_path(pidfile),
                  _autoscaler_path(pidfile), _lb_path(pidfile),
                  _rollout.request_path(pidfile)):
            # the rollout STATE file deliberately survives: it pins the
            # per-replica version assignments across a supervisor restart
            try:
                os.unlink(p)
            except OSError:
                pass
        # span spools deliberately survive shutdown: `manager trace` is a
        # post-mortem tool as much as a live one
        sys.exit(0)

    # the handler only notes the signal: the loop below shuts the fleet
    # down between its passes, never from inside a handler that may have
    # interrupted the main thread holding a lock (the recorder's, the
    # LB's registry)
    signals: list = []

    def _note(signum, frame):
        signals.append(signum)

    signal.signal(signal.SIGTERM, _note)
    signal.signal(signal.SIGINT, _note)
    while not signals:
        try:
            with open(scale_path) as f:
                desired = max(0, int(f.read().strip()))
        except (OSError, ValueError):
            desired = replicas
        # reap exits (crash -> respawn below; scale-down exit -> forget)
        for index, pid in list(children.items()):
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid
            if done:
                children.pop(index)
                was_retiring = index in stopping
                was_rolling = index in rolling
                stopping.discard(index)
                rolling.discard(index)
                if index < desired:
                    print(json.dumps({"replica": index, "pid": pid,
                                      "event": "exited; respawning",
                                      "rolling": was_rolling}),
                          file=sys.stderr, flush=True)
                    recorder.record("replica_exit", index=index, pid=pid,
                                    respawning=True, rolling=was_rolling)
                    if was_rolling:
                        # rollout: an INTENTIONAL replace — the
                        # old process finished its retire-drain; the
                        # respawn below brings the slot up at its newly
                        # assigned version.  Not a crash, no incident.
                        pass
                    else:
                        if rst.get("phase") != "idle" and \
                                _assigned_version(index) == rst.get(
                                    "target"):
                            # a replica already moved to the rollout
                            # target died unexpectedly: crash evidence
                            # for the canary judge
                            rollout_meta["canary_crashes"] += 1
                        if inc_on_crash:
                            # an unexpected replica death IS the
                            # incident — bundle every process's recent
                            # events/spans/health before evidence rotates
                            _capture_incident(
                                f"replica-{index}-crash",
                                meta={"replica": index, "pid": pid})
                else:
                    recorder.record("replica_exit", index=index, pid=pid,
                                    respawning=False,
                                    retired=was_retiring)
        # scale down: highest-numbered replicas RETIRE (SIGUSR1: drain
        # their in-flight work, shared admission stays open for the
        # survivors) and exit; signalled once — a repeat would re-enter
        # the replica's drain handler
        retire_sig = getattr(signal, "SIGUSR1", signal.SIGTERM)
        for index in sorted(children, reverse=True):
            if index >= desired and index not in stopping:
                stopping.add(index)
                recorder.record("replica_retire", index=index)
                try:
                    os.kill(children[index], retire_sig)
                except OSError:
                    pass
        # spawn missing replicas, rate-limited to one respawn per second
        # per slot so a crash-looping config cannot fork-bomb the host
        now = time.monotonic()
        for index in range(desired):
            if index not in children and \
                    now - last_spawn.get(index, -1e9) >= 1.0:
                _spawn(index)
        # zero-drop rollout: drive the canary / rolling-replace /
        # rollback state machine off the same per-replica health
        # snapshots the incident triggers read.  Never load-bearing for
        # the fleet's liveness: a tick error logs and retries next pass.
        try:
            _rollout_tick(desired)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"event": "rollout tick error",
                              "error": f"{type(e).__name__}: {e}"}),
                  file=sys.stderr, flush=True)
        # SLO-burn incident trigger: the replicas' health
        # snapshots already land next to the pidfile every second —
        # cheap file reads, throttled by the capture cooldown itself
        if inc_burn is not None:
            worst = None
            for index in range(desired):
                try:
                    with open(_health_path(
                            _replica_pidfile(pidfile, index))) as f:
                        doc = json.load(f)
                    br = (doc.get("slo") or {}).get("burn_rate")
                    if isinstance(br, (int, float)):
                        worst = br if worst is None else max(worst, br)
                except (OSError, ValueError):
                    continue
            if worst is not None and worst >= inc_burn:
                _capture_incident(
                    f"slo-burn {worst:.2f} >= threshold {inc_burn:.2f}",
                    meta={"burn_rate": round(float(worst), 4),
                          "threshold": inc_burn})
        # the supervisor's own events (spawns, retires, autoscaler
        # decisions, LB member flips) spool next to the replicas'
        _drain_events(pidfile, source="supervisor")
        if scaler is not None:
            # controller observability through `manager metrics`: persist
            # the decision counters / target gauges / decision log next to
            # the pidfile (atomic, same pattern as the health snapshots)
            try:
                snap_path = _autoscaler_path(pidfile)
                with open(snap_path + ".tmp", "w") as f:
                    json.dump(scaler.snapshot(), f)
                os.replace(snap_path + ".tmp", snap_path)
            except OSError:
                pass
        if balancer is not None:
            # the front door's half of fleet observability — its
            # root spans to the LB spool, its registry (lb_requests_total
            # / lb_retries_total / member gauges + exposition) to
            # <pidfile>.lb.json so `manager metrics --all-replicas`
            # includes the LB instead of leaving it invisible
            try:
                balancer.drain_spans_to_spool()
            except Exception:  # noqa: BLE001 — never load-bearing
                pass
            try:
                lb_path = _lb_path(pidfile)
                with open(lb_path + ".tmp", "w") as f:
                    json.dump({"url": balancer.url, "ts": time.time(),
                               "snapshot": balancer.registry.snapshot(),
                               "prom": balancer.registry.to_prometheus()},
                              f)
                os.replace(lb_path + ".tmp", lb_path)
            except (OSError, TypeError, ValueError):
                pass
        for _ in range(5):                 # a pass every 0.5 s
            if signals:
                break
            time.sleep(0.1)
    _terminate()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="cluster-serving")
    ap.add_argument("action",
                    choices=["start", "stop", "status", "restart", "health",
                             "replay", "metrics", "scale", "warmup",
                             "trace", "incident", "profile", "publish",
                             "versions", "rollout", "usage"])
    ap.add_argument("value", nargs="?", default=None,
                    help="scale: target replica count; trace: the "
                         "trace_id to reconstruct; incident --show: the "
                         "bundle name (default latest); profile: the "
                         "replica index (default 0); publish/rollout: "
                         "the version name")
    ap.add_argument("-c", "--config", default="config.yaml")
    ap.add_argument("--pidfile", default=PIDFILE)
    ap.add_argument("--foreground", action="store_true")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="start: run N supervised serving replicas over the "
                         "shared queue (crashed replicas respawn; their "
                         "in-flight records are reclaimed by survivors)")
    ap.add_argument("--autoscale", action="store_true",
                    help="start --replicas: run the closed-loop autoscaler "
                         "in the supervisor (config `autoscaler:` section "
                         "tunes it); topology via the scale file, knob "
                         "nudges via <pidfile>.knobs.json")
    ap.add_argument("--lb-port", type=int, default=None, metavar="P",
                    help="start --replicas: serve the single-port "
                         "load-balancing front door on P (proxies "
                         "/v1/enqueue + /v1/result across the live replica "
                         "gateways)")
    ap.add_argument("--all-replicas", action="store_true",
                    help="metrics: one fleet-wide snapshot summed across "
                         "the per-replica registries (HTTP scrape with "
                         "health.json fallback); with --prom, the merged "
                         "text exposition")
    ap.add_argument("--filter", default=None, metavar="SUBSTR",
                    help="replay only dead letters whose uri or error "
                         "contains SUBSTR")
    ap.add_argument("--prom", action="store_true",
                    help="metrics: print the Prometheus text exposition "
                         "(requires params.http_port on the daemon)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="start --replicas: skip the supervisor's "
                         "throwaway warm-up pass (replicas then compile "
                         "for themselves on first boot)")
    ap.add_argument("--slowest", type=int, default=None, metavar="N",
                    help="trace: rank the N slowest traces fleet-wide "
                         "instead of reconstructing one")
    ap.add_argument("--chrome", default=None, metavar="PATH",
                    help="trace: export the merged fleet timeline as "
                         "Chrome trace-event JSON (one track per "
                         "process) for Perfetto")
    ap.add_argument("--list", action="store_true", dest="list_",
                    help="incident: list captured bundles")
    ap.add_argument("--show", action="store_true",
                    help="incident: render a bundle's merged "
                         "cross-process timeline (recorder events + "
                         "trace spans); pass the bundle name as the "
                         "positional value, default latest")
    ap.add_argument("--last", type=int, default=200, metavar="N",
                    help="incident --show: timeline entries to render "
                         "(default 200)")
    ap.add_argument("--seconds", type=float, default=5.0, metavar="S",
                    help="profile: trace duration (default 5s)")
    ap.add_argument("--version", default=None, metavar="V",
                    help="warmup: warm the registry snapshot for version "
                         "V (no re-export) — the rollout's pre-warm pass "
                         "runs this so replaced replicas boot with zero "
                         "compiles")
    ap.add_argument("--since", type=float, default=None, metavar="EPOCH",
                    help="usage: only count journal deltas drained after "
                         "this wall time (epoch seconds)")
    ap.add_argument("--by", default="tenant", choices=["tenant", "model"],
                    help="usage: rollup dimension (default tenant)")
    ap.add_argument("--json", action="store_true", dest="json_",
                    help="usage: print the rollup as JSON")
    args = ap.parse_args(argv)

    def read_pid():
        try:
            with open(args.pidfile) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    def read_health():
        try:
            with open(_health_path(args.pidfile)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    if args.action == "warmup":
        # zero cold start: one throwaway pass that persists the
        # deployment's warm state next to the pidfile — the mmap weight
        # store, quantized first when params.quantize is set — and runs
        # the warm pass, which on the card builds the kernel libraries
        # under build/.  Run standalone at deploy time, or implicitly by
        # `start --replicas` (the supervisor's pre-warm subprocess IS
        # this action).  `cache_dir` stays null: there is no compile
        # cache to fill, and CUDA graphs do not outlive this process.
        from analytics_zoo_tpu_torch.inference import weightstore
        from analytics_zoo_tpu_torch.inference.quantize import quantized_bits
        cfg = load_config(args.config)
        params = serving_params(cfg)
        cache_dir = _resolve_cache_dir(params, args.pidfile)
        if args.version:
            # rollout pre-warm: load and warm the REGISTRY snapshot for
            # this version — verified first, never re-exported (published
            # versions are immutable)
            from analytics_zoo_tpu_torch.serving import registry as _registry
            try:
                ver = _registry.resolve(_registry_dir(args.pidfile),
                                        args.version,
                                        model=_model_name(cfg))
                store = _version_store(args.pidfile, ver,
                                       _model_name(cfg))
            except _registry.RegistryError as e:
                print(json.dumps({"error": str(e)}), file=sys.stderr)
                return 1
            im = load_model(cfg, weight_store=store)
            stats = _warm_pass(im, params)
            print(json.dumps({"cache_dir": cache_dir,
                              "weight_store": store, "version": ver,
                              "load_seconds": im.load_seconds,
                              "load_mmap": im.load_mmap, **stats,
                              "kernels_built": _kernels_built()}))
            return 0 if stats["failed"] == 0 else 1
        store = _weights_dir(args.pidfile)
        im = load_model(cfg, weight_store=store)
        if params.quantize:
            # quantize BEFORE the export + warm-up: the store this pass
            # persists holds the packed int4 / int8 + scale leaves, so a
            # replica fork maps quantized weights and quantizes nothing.
            # A store already quantized (a prior warmup pass) restores
            # as-is and is skipped here.
            from analytics_zoo_tpu_torch.serving.engine import apply_quantize
            apply_quantize(im, params.quantize)
        exported = False
        if getattr(im, "_params", None):
            try:
                man = weightstore.save_store(
                    store, {"params": im._params,
                            "state": im._state or {}})
                exported = not man.get("skipped", False)
            except Exception as e:  # noqa: BLE001 — store is an optim,
                # not a correctness requirement
                print(json.dumps({"warning": f"weight store export "
                                             f"failed ({type(e).__name__}"
                                             f": {e})"}), file=sys.stderr)
                store = None
        else:
            store = None
        stats = _warm_pass(im, params)
        print(json.dumps({"cache_dir": cache_dir, "weight_store": store,
                          "store_exported": exported,
                          "load_seconds": im.load_seconds,
                          "load_mmap": im.load_mmap,
                          "quantized_bits": quantized_bits(
                              getattr(im, "_params", None) or {}),
                          **stats, "kernels_built": _kernels_built()}))
        return 0 if stats["failed"] == 0 else 1
    if args.action == "publish":
        # versioned model registry: build the deployment's model
        # per the CONFIG (never the shared weight store — a stale store
        # would republish the previous version's weights under a new
        # name), quantize like `manager warmup` would, export a staging
        # weight store, and snapshot it as one immutable version.
        if not args.value:
            print(json.dumps({"error": "publish needs a version name: "
                                       "manager publish <version>"}),
                  file=sys.stderr)
            return 1
        import shutil
        import tempfile
        from analytics_zoo_tpu_torch.inference import aot, weightstore
        from analytics_zoo_tpu_torch.serving import registry as _registry
        cfg = load_config(args.config)
        params = serving_params(cfg)
        model_name = _model_name(cfg)
        reg = _registry_dir(args.pidfile)
        im = load_model(cfg)
        if params.quantize:
            from analytics_zoo_tpu_torch.serving.engine import apply_quantize
            apply_quantize(im, params.quantize)
        if not getattr(im, "_params", None):
            print(json.dumps({"error": "publish needs a model with "
                                       "restorable params (zoo "
                                       "topology)"}), file=sys.stderr)
            return 1
        os.makedirs(reg, exist_ok=True)
        staging = tempfile.mkdtemp(prefix=".staging-", dir=reg)
        try:
            sdir = os.path.join(staging, "weights")
            weightstore.save_store(sdir, {"params": im._params,
                                          "state": im._state or {}})
            try:
                # the warm-up manifest rides the version doc, so ops can
                # see WHAT program set a version pre-warms without
                # loading it
                entries = aot.resolve_manifest(
                    im, params.warmup if params.warmup else True)
                wdoc = [_jsonable(e._asdict()) for e in entries]
            except Exception:  # noqa: BLE001 — metadata, never fatal
                wdoc = None
            try:
                doc = _registry.publish(
                    reg, args.value, sdir, model=model_name,
                    quantize=_jsonable(params.quantize),
                    warmup=wdoc,
                    meta={"config": os.path.abspath(args.config)})
            except _registry.RegistryError as e:
                print(json.dumps({"error": str(e)}), file=sys.stderr)
                return 1
        finally:
            shutil.rmtree(staging, ignore_errors=True)
        print(json.dumps({"published": doc["version"],
                          "model": model_name,
                          "fingerprint": doc["fingerprint"],
                          "registry": reg,
                          "latest": _registry.latest(reg, model_name)}))
        return 0
    if args.action == "versions":
        # registry inventory: every published version, latest marked
        from analytics_zoo_tpu_torch.serving import registry as _registry
        try:
            model_name = _model_name(load_config(args.config))
        except OSError:
            model_name = "default"
        reg = _registry_dir(args.pidfile)
        vs = _registry.versions(reg, model_name)
        print(json.dumps({
            "registry": reg, "model": model_name,
            "latest": _registry.latest(reg, model_name),
            "versions": [{k: v.get(k) for k in
                          ("version", "fingerprint", "created",
                           "quantize", "latest")} for v in vs]}))
        return 0
    if args.action == "rollout":
        # zero-drop rollout: verify the target version, then hand
        # the supervisor a request file (same file-not-signal pattern as
        # `manager scale`) — its poll loop runs the canary / rolling
        # replace / auto-rollback state machine
        from analytics_zoo_tpu_torch.serving import registry as _registry
        from analytics_zoo_tpu_torch.serving import rollout as _rollout
        if not args.value:
            print(json.dumps({"error": "rollout needs a version: "
                                       "manager rollout <version>"}),
                  file=sys.stderr)
            return 1
        pid = read_pid()
        if pid is None or not alive(pid):
            print(json.dumps({"error": "serving not running"}),
                  file=sys.stderr)
            return 1
        if not os.path.exists(_scale_path(args.pidfile)):
            print(json.dumps({"error": "not running as a replica "
                                       "supervisor (start with "
                                       "--replicas N)"}), file=sys.stderr)
            return 1
        try:
            model_name = _model_name(load_config(args.config))
        except OSError:
            model_name = "default"
        reg = _registry_dir(args.pidfile)
        try:
            ver = _registry.resolve(reg, args.value, model=model_name)
        except _registry.RegistryError as e:
            print(json.dumps({"error": str(e)}), file=sys.stderr)
            return 1
        problems = _registry.verify(reg, ver, model=model_name)
        if problems:
            # reject a corrupt version at the CLI already — the
            # supervisor re-verifies, but the operator should hear it now
            print(json.dumps({"error": f"version {ver!r} failed "
                                       "integrity verification",
                              "problems": problems[:5]}),
                  file=sys.stderr)
            return 1
        _rollout.write_request(args.pidfile, ver, time.time())
        print(json.dumps({"rollout": ver,
                          "state": _rollout.state_path(args.pidfile)}))
        return 0
    if args.action == "incident":
        # incident forensics: capture/list/show self-contained
        # bundles under <pidfile>.incidents/ — works on a live OR dead
        # deployment (post-mortem forensics reads files, not processes)
        from analytics_zoo_tpu_torch.serving import incident as _incident
        if args.list_:
            print(json.dumps({"incidents":
                              _incident.list_incidents(args.pidfile)}))
            return 0
        if args.show:
            bundle = _incident.resolve_bundle(args.pidfile, args.value)
            if bundle is None:
                print(json.dumps({"error": "no incident bundle found "
                                           f"(looked under "
                                           f"{args.pidfile}.incidents)"}),
                      file=sys.stderr)
                return 1
            print(json.dumps(_incident.render(bundle, last=args.last)))
            return 0
        # operator-triggered capture: flush this CLI process's view is
        # moot (replicas spool their own rings every second); just bundle
        bundle = _incident.capture(args.pidfile, "operator",
                                   meta={"via": "manager incident"})
        if bundle is None:
            print(json.dumps({"error": "nothing to capture (no spools/"
                                       "health snapshots next to "
                                       f"{args.pidfile})"}),
                  file=sys.stderr)
            return 1
        print(json.dumps({"captured": True, "bundle": bundle}))
        return 0
    if args.action == "profile":
        # on-demand device profiling: POST /debug/profile on the
        # target replica's PROBE port (never via the LB/gateway surface)
        try:
            params = serving_params(load_config(args.config))
        except OSError:
            params = ServingParams()
        if not params.http_port:
            print(json.dumps({"error": "profile needs params.http_port "
                                       "(the replica probe port)"}),
                  file=sys.stderr)
            return 1
        index = 0
        if args.value is not None:
            try:
                index = int(args.value)
            except ValueError:
                print(json.dumps({"error": f"profile: replica index "
                                           f"expected, got "
                                           f"{args.value!r}"}),
                      file=sys.stderr)
                return 1
        import urllib.error
        import urllib.request
        url = (f"http://{params.http_host}:{params.http_port + index}"
               f"/debug/profile?seconds={max(args.seconds, 0.05):g}")
        try:
            req = urllib.request.Request(url, data=b"", method="POST")
            with urllib.request.urlopen(
                    req, timeout=10.0) as resp:
                print(json.dumps(json.loads(resp.read())))
                return 0
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except (ValueError, OSError):
                body = {"error": f"HTTP {e.code}"}
            print(json.dumps(dict(body, code=e.code)), file=sys.stderr)
            return 1
        except Exception as e:  # noqa: BLE001 — replica down
            print(json.dumps({"error": f"replica {index} probe port "
                                       f"unreachable ({type(e).__name__}"
                                       f": {e})"}), file=sys.stderr)
            return 1
    if args.action == "trace":
        # fleet-wide trace reconstruction: merge every span spool
        # of the deployment (per-replica + LB, written next to the health
        # snapshots), normalize each process's monotonic clock onto the
        # wall clock, and either reconstruct ONE request's cross-process
        # timeline, rank the slowest traces, or export the whole timeline
        # as Chrome trace-event JSON.
        from analytics_zoo_tpu_torch.serving import fleet as _fleet
        from analytics_zoo_tpu_torch.serving import tracecollect
        try:
            params = serving_params(load_config(args.config))
        except OSError:
            params = ServingParams()
        count = _fleet.read_scale(args.pidfile)
        docs = _fleet.replica_docs(
            args.pidfile, http_host=params.http_host,
            http_port=params.http_port, count=count) if count else {}
        by_rid = {str(d.get("replica_id") or f"replica-{i}"): d
                  for i, d in docs.items()}
        spans = tracecollect.collect(args.pidfile, health_docs=by_rid)
        if not spans:
            print(json.dumps(
                {"error": "no span spools found (nothing matching "
                          f"{args.pidfile}*.spans.jsonl — is tracing on "
                          "and the deployment running/ran?)"}),
                file=sys.stderr)
            return 1
        if args.chrome:
            tracecollect.export_chrome_trace(spans, args.chrome)
            print(json.dumps({"chrome_trace": args.chrome,
                              "spans": len(spans)}))
            return 0
        if args.slowest is not None:
            print(json.dumps(
                {"slowest": tracecollect.slowest(spans, args.slowest),
                 "spans": len(spans)}))
            return 0
        if not args.value:
            print(json.dumps({"error": "pass a trace_id (or --slowest N "
                                       "/ --chrome PATH)"}),
                  file=sys.stderr)
            return 1
        doc = tracecollect.reconstruct(spans, args.value)
        print(json.dumps(doc))
        return 0 if doc.get("found") else 1
    if args.action == "usage":
        # usage metering rollup: load every replica's usage
        # journal (rotated generations included), normalize the drain
        # clocks, and sum the per-interval deltas by tenant or model.
        # Works on a STOPPED deployment — the journal survives `manager
        # stop` precisely so billing can run after the fact.
        from analytics_zoo_tpu_torch.serving import tracecollect
        paths = tracecollect.find_usage_spools(args.pidfile)
        if not paths:
            print(json.dumps(
                {"error": "no usage journals found (nothing matching "
                          f"{args.pidfile}*.usage.jsonl — is metering "
                          "on and the deployment running/ran?)"}),
                file=sys.stderr)
            return 1
        records = tracecollect.load_usage(paths)
        doc = tracecollect.aggregate_usage(records, by=args.by,
                                           since=args.since)
        doc["journals"] = len(paths)
        if args.json_:
            print(json.dumps(doc))
            return 0
        hdr = (f"{args.by:<24} {'records':>10} {'tokens':>10} "
               f"{'device_s':>12} {'bytes':>12} {'sheds':>8}")
        print(hdr)
        print("-" * len(hdr))
        for key, vals in doc["usage"].items():
            print(f"{key:<24} {vals['records']:>10} {vals['tokens']:>10} "
                  f"{vals['device_s']:>12} {vals['bytes']:>12} "
                  f"{vals['sheds']:>8}")
        print(f"({doc['intervals']} journal interval(s) across "
              f"{doc['journals']} journal(s))")
        return 0
    if args.action == "metrics":
        # live metrics snapshot.  Preferred source: the daemon's own
        # /metrics endpoint (exactly what a scraper sees, including
        # ?format=prom); fallback: derive the JSON document from the
        # health.json snapshot the daemon writes every second.
        try:
            params = serving_params(load_config(args.config))
        except OSError:
            params = ServingParams()       # no config: snapshot-only path
        if args.all_replicas:
            # fleet-wide aggregation: sum the per-replica
            # registries — the same serving/fleet.py path the autoscaler's
            # ManagerFleet collector consumes
            from analytics_zoo_tpu_torch.serving import fleet as _fleet
            count = _fleet.read_scale(args.pidfile)
            if args.prom:
                texts = _fleet.scrape_prometheus(
                    count, http_host=params.http_host,
                    http_port=params.http_port)
                if not texts:
                    print(json.dumps(
                        {"error": "--all-replicas --prom needs reachable "
                                  "replica probe ports (params.http_port "
                                  "+ a running --replicas deployment)"}),
                        file=sys.stderr)
                    return 1
                out = _fleet.merge_prometheus(texts)
                asnap = _fleet.autoscaler_snapshot(args.pidfile)
                if asnap and asnap.get("prom"):
                    out += asnap["prom"]   # controller series ride along
                lbsnap = _fleet.lb_snapshot(args.pidfile)
                if lbsnap and lbsnap.get("prom"):
                    # the front door's own exposition
                    # (lb_requests_total / lb_retries_total / member
                    # gauges) joins the fleet scrape
                    out += lbsnap["prom"]
                print(out, end="")
                return 0
            docs = _fleet.replica_docs(args.pidfile,
                                       http_host=params.http_host,
                                       http_port=params.http_port,
                                       count=count)
            if not docs:
                print(json.dumps(
                    {"error": "no replica health docs (not running as a "
                              "--replicas deployment, or none written "
                              "yet)"}), file=sys.stderr)
                return 1
            doc = _fleet.fleet_metrics(docs,
                                       lb=_fleet.lb_snapshot(args.pidfile))
            asnap = _fleet.autoscaler_snapshot(args.pidfile)
            if asnap:
                doc["autoscaler"] = {
                    "decisions": asnap.get("decisions", [])[-20:],
                    "metrics": asnap.get("metrics", {})}
            print(json.dumps(doc))
            return 0
        if params.http_port:
            import urllib.request
            url = (f"http://{params.http_host}:{params.http_port}/metrics"
                   + ("?format=prom" if args.prom else ""))
            try:
                with urllib.request.urlopen(url, timeout=2.0) as resp:
                    body = resp.read().decode()
                print(body if args.prom else json.dumps(json.loads(body)))
                return 0
            except Exception as e:  # noqa: BLE001 — daemon down/unreachable
                print(json.dumps({"warning": f"probe endpoint {url} "
                                             f"unreachable "
                                             f"({type(e).__name__}: {e}); "
                                             "falling back to the health "
                                             "snapshot"}), file=sys.stderr)
        if args.prom:
            print(json.dumps({"error": "--prom needs a reachable "
                                       "params.http_port probe endpoint"}),
                  file=sys.stderr)
            return 1
        health = read_health()
        if health is None:
            print(json.dumps({"error": "no health snapshot (serving not "
                                       "running, or not yet written)"}),
                  file=sys.stderr)
            return 1
        pid = read_pid()
        doc = ClusterServing.metrics_from_health(health)
        if pid is None or not alive(pid):
            doc["stale"] = True            # snapshot outlived its daemon
        print(json.dumps(doc))
        return 0
    if args.action == "replay":
        # dead-letter replay (ROADMAP open item): re-enqueue quarantined
        # records after a fix — works against the live daemon's backend
        # (file/redis are cross-process), no model load needed
        queue = build_queue(load_config(args.config))
        sub = args.filter
        filt = None if sub is None else (
            lambda e: sub in str(e.get("uri", ""))
            or sub in str(e.get("error", "")))
        out = queue.replay_dead_letters(filter=filt)
        # admission_open=false explains a 0-replayed run: a drained queue
        # rejects re-enqueues until serving starts again (which reopens it)
        print(json.dumps({"replayed": len(out["replayed"]),
                          "skipped": len(out["skipped"]),
                          "uris": out["replayed"],
                          "admission_open": bool(
                              queue.health().get("admission_open", True))}))
        return 0
    if args.action == "scale":
        # resize a running --replicas supervisor: write the desired count,
        # the supervisor's poll loop spawns/drains to match
        if args.value is None:
            print(json.dumps({"error": "scale needs a target count: "
                                       "manager scale N"}), file=sys.stderr)
            return 1
        n = int(args.value)
        pid = read_pid()
        if pid is None or not alive(pid):
            print(json.dumps({"error": "serving not running"}),
                  file=sys.stderr)
            return 1
        if not os.path.exists(_scale_path(args.pidfile)):
            print(json.dumps({"error": "not running as a replica "
                                       "supervisor (start with "
                                       "--replicas N)"}), file=sys.stderr)
            return 1
        with open(_scale_path(args.pidfile), "w") as f:
            f.write(str(n))
        print(json.dumps({"replicas": n}))
        return 0
    if args.action == "status":
        pid = read_pid()
        up = pid is not None and alive(pid)
        out = {"running": up, "pid": pid if up else None}
        if os.path.exists(_scale_path(args.pidfile)):
            # replica-supervisor deployment: per-replica liveness
            try:
                with open(_scale_path(args.pidfile)) as f:
                    desired = int(f.read().strip())
            except (OSError, ValueError):
                desired = 0
            replicas = {}
            warming = 0
            for i in range(desired):
                rp = _replica_pidfile(args.pidfile, i)
                try:
                    with open(rp) as f:
                        rpid = int(f.read().strip())
                except (OSError, ValueError):
                    rpid = None
                member = {"pid": rpid,
                          "alive": rpid is not None and alive(rpid)}
                # zero cold start: per-replica warm-up state off
                # the health snapshot, so an operator can see WHY a fresh
                # replica is not taking traffic yet (warming k/n) without
                # curling its probe port
                try:
                    with open(_health_path(rp)) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    doc = None
                if isinstance(doc, dict):
                    w = doc.get("warmup") or {}
                    if w.get("state") and w["state"] != "off":
                        member["warmup"] = {
                            k: w.get(k)
                            for k in ("state", "compiled", "total",
                                      "seconds")}
                        if w["state"] in ("pending", "warming"):
                            warming += 1
                    member["ready"] = bool(
                        (doc.get("ready") or {}).get("ready"))
                    if doc.get("cold_start_s") is not None:
                        member["cold_start_s"] = doc["cold_start_s"]
                    if doc.get("model_version") is not None:
                        # rollout: which registry version this
                        # replica serves — mixed mid-rollout is normal
                        member["model_version"] = doc["model_version"]
                replicas[f"r{i}"] = member
            out["replicas"] = {"desired": desired, "warming": warming,
                               "members": replicas}
            from analytics_zoo_tpu_torch.serving import rollout as _rollout
            if os.path.exists(_rollout.state_path(args.pidfile)):
                out["rollout"] = _rollout.load_state(args.pidfile)
        health = read_health()
        if health is not None:
            out["health"] = health
        print(json.dumps(out))
        return 0
    if args.action == "health":
        # worker-level health (supervision state, restart counts, dead-letter
        # and breaker status) written by the serving daemon each second.
        # Cross-checked against pid liveness: a SIGKILLed daemon leaves a
        # stale snapshot behind and must not report healthy forever.
        health = read_health()
        if health is None:
            print(json.dumps({"error": "no health snapshot (serving not "
                                       "running, or not yet written)"}),
                  file=sys.stderr)
            return 1
        pid = read_pid()
        if pid is None or not alive(pid):
            health["running"] = False
            health["stale"] = True
            print(json.dumps(health), file=sys.stderr)
            return 1
        print(json.dumps(health))
        # a live daemon whose workers are FAILED is not healthy: exit
        # nonzero so liveness probes that check the code catch it
        return 0 if health.get("running") else 1
    if args.action in ("stop", "restart"):
        pid = read_pid()
        if pid is not None and alive(pid):
            os.kill(pid, signal.SIGTERM)
            for _ in range(50):
                if not alive(pid):
                    break
                time.sleep(0.1)
        if args.action == "stop":
            print(json.dumps({"stopped": True}))
            return 0
        if pid is not None and alive(pid):
            print(json.dumps({"error": f"pid {pid} did not terminate"}),
                  file=sys.stderr)
            return 1
    # start / restart
    pid = read_pid()
    if pid is not None and alive(pid):
        print(json.dumps({"error": f"already running (pid {pid})"}),
              file=sys.stderr)
        return 1
    if args.replicas is not None and args.replicas >= 1:
        # replica-supervisor deployment — including --replicas 1, so
        # a single-replica start can still be resized later with `manager
        # scale N`.  The shared-queue contract needs a CROSS-PROCESS
        # backend: an inproc queue would give every replica its own
        # private stream
        src = str(load_config(args.config).get("data", {})
                  .get("src", "redis"))
        if src == "inproc":
            print(json.dumps({"error": "--replicas needs a cross-process "
                                       "queue (data.src: redis or "
                                       "file:<dir>), not inproc"}),
                  file=sys.stderr)
            return 1
        if args.foreground:
            _run_supervisor(args.config, args.pidfile, args.replicas,
                            autoscale=args.autoscale, lb_port=args.lb_port,
                            prewarm=not args.no_prewarm)
            return 0
        pid = os.fork()
        if pid == 0:                       # child: detach and supervise
            os.setsid()
            _run_supervisor(args.config, args.pidfile, args.replicas,
                            autoscale=args.autoscale, lb_port=args.lb_port,
                            prewarm=not args.no_prewarm)
            return 0
        print(json.dumps({"started": True, "pid": pid,
                          "replicas": args.replicas}))
        return 0
    if args.foreground:
        _run_foreground(args.config, args.pidfile)
        return 0
    pid = os.fork()
    if pid == 0:                           # child: detach and serve
        os.setsid()
        _run_foreground(args.config, args.pidfile)
        return 0
    print(json.dumps({"started": True, "pid": pid}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
