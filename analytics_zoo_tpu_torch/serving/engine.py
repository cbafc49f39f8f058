"""Cluster Serving engine — queue -> model -> result store, in two modes.

Reference parity: `ClusterServing.main` (serving/ClusterServing.scala:34-352)
reads a stream, batches, runs the model and writes a result table with
back-pressure.  This is the port of the JAX package's ``serving/engine.py``
for its two data planes:

- **predict** (``params.generation`` unset): records are decoded into
  tensors, grouped by shape, dispatched to ``InferenceModel.dispatch``
  without waiting for the device, and a separate write worker reads each
  batch back, post-processes every row (top-N classes by default) and
  writes the results — three supervised workers (``serving-preprocess``,
  ``serving-predict``, ``serving-write``) with ``inflight_batches`` as the
  bound between the last two.  A batch whose predict fails is bisected so
  only the poison row is dead-lettered.  ``params.quantize`` quantizes the
  model (int8 / int4 weights) at construction.
- **generation** (``params.generation`` set): records carrying prompt
  token ids feed the continuous batcher (``serving/generate.py``, paged or
  monolithic lanes); every terminal result, streamed partial, quarantine
  and deadline shed is written back under the queue's lease contract.
- **warm-up** (``params.warmup``): at ``start`` a daemon thread warms the
  batcher's program set (its decode quanta captured as CUDA graphs), or
  the predict model's buckets (``inference/aot.warm_up``); ``health()``
  and ``ready()`` report its progress, and readiness waits for it.
- **generation continuity** (``generation.checkpoint_interval``,
  ``generation.resume``): at each step boundary the engine spools the
  batcher's checkpoints to ``snapshot_path`` (``serving/tracecollect.py``;
  the engine's owner sets the path) with an integrity checksum, and a
  generation request carries a lease annotation pointing the next owner at
  that spool.  A reclaimed generation record whose dead owner left a
  valid checkpoint of the matching epoch resumes from it; any other
  reclaim restarts from token 0, and the tokens recomputed are counted.
- **fault injection** (``params.faults``, ``serving/faults.py``): predict
  errors and delays, a warm-up crash, held readiness, claim stalls,
  rejects at the admission gate, a crash after n generated tokens and
  corrupt checkpoints, each gated on ``model_version``.
- **front door** (``params.http_port``, ``serving/http.py``): the probes
  (``/healthz``, ``/readyz``, ``/metrics``), the ingestion gateway
  (``/v1/enqueue``, ``/v1/result/<uri>``) and ``/debug/profile``, which
  arms one ``torch.profiler`` trace (``start_profile``).
- **armour** (``params.admission``, ``params.brownout``): the tenant
  admission gate the gateway consults per request (``admit_record``,
  ``serving/admission.py``), the brownout ladder driven by the SLO burn
  rate (``serving/brownout.py``: partials suppressed, generation budgets
  of non-interactive traffic clamped, best-effort shed at the door), and
  the priority-ordered claim with its shed and deadline early-drop gates.
- **usage metering** (``params.metering``, on unless ``False``:
  ``serving/metering.py``): records, tokens, sheds, wire bytes and device
  seconds charged to the tenant the gateway stamped, drained by
  ``drain_usage``.
- **operator surface**: live ``retune`` of the data-plane knobs (applied
  at the preprocess loop's batch boundary, shown by ``knobs()``), the
  ``resources`` block (``inference/resources.ResourceLedger``: weights,
  decode state and CUDA-graph pools, also the
  ``serving_hbm_bytes{component=}`` gauges) and the ``process`` block.

Kept from the JAX engine, with the same contracts:

- **supervised workers** — crash -> log -> backoff -> restart, capped
  (``SupervisedThread``).
- **per-record fault isolation** — a malformed or poisoned record gets an
  error RESULT plus a dead-letter entry; its neighbours keep serving.
- **leases** — reads CLAIM records; the claim is released (``ack``) only
  after the record's terminal state is written, and a periodic RECLAIM
  sweep re-serves records a dead replica left behind (duplicates
  suppressed when a result already exists).
- **deadlines** — an expired ``deadline_ns`` sheds the record at read, at
  the predict gate or at a step boundary with a ``deadline-exceeded``
  marker.
- **telemetry** — the metrics registry, per-record spans keyed by the
  wire-stamped ``trace_id``, the flight recorder, optional SLO
  attribution, and the ``health()`` / ``metrics()`` documents.

Not in this slice (setting them raises ``NotImplementedError``):
TensorBoard summaries (``tensorboard_dir``), sharding (``sharding``,
``mesh_shape``) and XLA's persistent compilation cache
(``compile_cache_dir``: the kernel libraries are cached under ``build/``
already, and nothing else is compiled).  Image records (``image``:
base64 PNG / JPEG bytes) are decoded with ``cv2`` as the JAX engine
decodes them; where OpenCV is missing such a record fails alone.
"""

from __future__ import annotations

import base64
import contextlib
import itertools
import logging
import os
import threading
import time
from queue import Empty as _EMPTY
from queue import Full as _FULL
from queue import Queue
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.observability import (MetricsRegistry,
                                                          SloTracker,
                                                          SpanContext,
                                                          Tracer,
                                                          get_recorder,
                                                          new_trace_id,
                                                          process_stats,
                                                          trace_sampled)
from analytics_zoo_tpu_torch.common.resilience import (CircuitBreaker,
                                                       CircuitBreakerOpen,
                                                       RetryPolicy,
                                                       SupervisedThread,
                                                       wait_until)
from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.inference.quantize import quantized_bits
from analytics_zoo_tpu_torch.inference.resources import ResourceLedger
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.serving import tracecollect
from analytics_zoo_tpu_torch.serving import wire as _wire
from analytics_zoo_tpu_torch.serving.admission import (PRIORITIES,
                                                       AdmissionController,
                                                       deadline_unmeetable,
                                                       normalize_priority,
                                                       normalize_tenant,
                                                       pressure_level,
                                                       shed_classes)
from analytics_zoo_tpu_torch.serving.brownout import BrownoutLadder
from analytics_zoo_tpu_torch.serving.faults import FaultInjector
from analytics_zoo_tpu_torch.serving.generate import (ContinuousBatcher,
                                                      GenerationParams,
                                                      GenRequest)
from analytics_zoo_tpu_torch.serving.metering import UsageMeter
from analytics_zoo_tpu_torch.serving.queues import BaseQueue

logger = logging.getLogger(__name__)


class QuantizedTensor(NamedTuple):
    """A tensor kept in its compact integer dtype (int8 wire records,
    uint8 image records) until it reaches the device."""

    data: np.ndarray      # int8 / uint8
    scale: float


def _wire_fmt_label(record: Dict) -> str:
    """Metric label for a record's wire format.  The field is producer-
    controlled, so anything but the known binary tags folds into the json
    label (an unhashable value or unbounded distinct strings must not
    reach the labels() call)."""
    fmt = record.get("wire_fmt")
    return fmt if fmt in (_wire.FMT_BIN, _wire.FMT_SHM) else _wire.FMT_JSON


def _decode_tensor_record(record: Dict):
    """Binary-wire decode: materialize a frame-decoded record — inline
    ``payload`` memoryview or shared-memory slot reference — with one copy
    (the float32 normalization).  A shm slot is re-verified AFTER the copy:
    a producer lapping the ring mid-read raises ``FrameError`` -> per-record
    quarantine, never torn bytes served as data."""
    view, shm_ref = _wire.resolve_payload(record)
    dtype = np.dtype(record.get("dtype", "<f4"))
    arr = np.frombuffer(view, dtype)
    if "shape" in record:
        arr = arr.reshape([int(s) for s in record["shape"]])
    if "scale" in record and record.get("dtype") == "<i1":
        out = QuantizedTensor(arr.astype(np.int8), float(record["scale"]))
    elif "scale" in record:
        out = arr.astype(np.float32) * float(record["scale"])
    else:
        out = arr.astype(np.float32)
    _wire.COPY_STATS.record("normalize", arr.nbytes)
    if shm_ref is not None:
        _wire.attach_ring(shm_ref).verify(shm_ref)
    return out


def default_preprocess(record: Dict):
    """Record -> tensor (PreProcessing.scala:1-53): binary frames
    (``payload``/``shm``), a base64 encoded ``image`` decoded to HWC BGR
    (f32, converted before an optional ``resize`` [h, w]; with ``u8`` it
    stays uint8, resized as uint8, as a ``QuantizedTensor`` of scale 1.0
    that is dequantized on the device), the base64 tensor record (``b64``
    + ``dtype``/``shape``; int8 with a ``scale`` stays quantized as a
    ``QuantizedTensor``), or a raw ``data`` list."""
    if "payload" in record or "shm" in record:
        return _decode_tensor_record(record)
    if "image" in record:
        from analytics_zoo_tpu_torch.feature.image import _cv2
        cv = _cv2()
        buf = np.frombuffer(base64.b64decode(record["image"]), np.uint8)
        img = cv.imdecode(buf, cv.IMREAD_COLOR)
        if img is None:
            raise ValueError("image record: the bytes do not decode as an "
                             "image")
        if record.get("u8"):
            if "resize" in record:
                h, w = record["resize"]
                img = cv.resize(img, (w, h))
            return QuantizedTensor(np.asarray(img, np.uint8), 1.0)
        # the float path converts BEFORE resizing (float interpolation)
        img = img.astype(np.float32)
        if "resize" in record:
            h, w = record["resize"]
            img = cv.resize(img, (w, h))
        return img
    if "b64" in record:
        raw = base64.b64decode(record["b64"])
        _wire.COPY_STATS.record("b64_decode", len(raw))
        arr = np.frombuffer(raw, np.dtype(record.get("dtype", "<f4")))
        if "shape" in record:
            arr = arr.reshape([int(s) for s in record["shape"]])
        if "scale" in record:
            # int8 wire: stay int8 until on the device; a float record
            # carrying a stray scale is dequantized on the host
            if record.get("dtype") == "<i1":
                out = QuantizedTensor(arr.astype(np.int8),
                                      float(record["scale"]))
            else:
                out = arr.astype(np.float32) * float(record["scale"])
        else:
            out = arr.astype(np.float32)
        _wire.COPY_STATS.record("normalize", arr.nbytes)
        return out
    if "data" in record:
        arr = np.asarray(record["data"], np.float32)
        if "shape" in record:
            arr = arr.reshape(record["shape"])
        return arr
    raise ValueError(f"record has no b64/data/payload: {list(record)}")


def default_postprocess(probs: np.ndarray, top_n: int = 5) -> List:
    """top-N ``[class, prob]`` pairs (PostProcessing.scala:1-117):
    ``np.argpartition`` pulls the top slice, then only that slice is
    sorted."""
    n = probs.shape[-1]
    if top_n >= n:
        idx = np.argsort(-probs)
    else:
        part = np.argpartition(-probs, top_n)[:top_n]
        idx = part[np.argsort(-probs[part])]
    return [[int(i), float(probs[i])] for i in idx]


class _Staged(NamedTuple):
    """One same-shape micro-batch staged between preprocess and the
    predict (or generate) worker."""

    ids: List
    tensors: np.ndarray
    scales: Optional[np.ndarray]
    deadlines: Optional[List]
    traces: Optional[List]        # per-record trace_id (wire-stamped)
    t_read: Optional[float]       # monotonic: read_batch returned
    t_ready: Optional[float]      # monotonic: preprocess/grouping done
    metas: Optional[List] = None  # per-record `gen` options + tenant


class _InFlight(NamedTuple):
    """One dispatched batch between the predict and write workers.  Keeps
    the host tensors so a failure surfacing at readback can still
    bisect-quarantine the poison row."""

    ids: List
    tensors: np.ndarray
    scales: Optional[np.ndarray]
    handle: object                # .result() -> host outputs, or raises
    traces: Optional[List]
    t_read: Optional[float]
    t_dispatch: float
    tenants: Optional[List] = None    # per-row tenant (usage attribution)


class _LazyResult:
    """The predict call itself deferred to ``.result()`` (a customized
    ``do_predict`` without a matching ``dispatch``)."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def result(self):
        return self._fn()


class _FailedDispatch:
    """A dispatch that raised synchronously: raises at ``.result()`` like
    any other failure, so the write stage owns the bisect."""

    def __init__(self, exc: BaseException):
        self._exc = exc

    def result(self):
        raise self._exc


def resolve_quantize_spec(q) -> Optional[Dict]:
    """Normalize ``ServingParams.quantize`` to ``{"bits", "group_size",
    "percentile", "calib"}`` (or None = off).  Accepts None/False,
    "int8"/"int4", 8/4, or a dict with those keys."""
    if not q:
        return None
    if isinstance(q, dict):
        spec = dict(q)
    elif q in ("int8", "int4", 8, 4, "8", "4", True):
        spec = {"bits": 8 if q in ("int8", 8, "8", True) else 4}
    else:
        raise ValueError(
            f"quantize={q!r}: expected int8|int4|8|4 or a spec dict")
    bits = int(spec.get("bits", 8))
    if bits not in (8, 4):
        raise ValueError(f"quantize.bits={bits!r}: expected 8 or 4")
    return {"bits": bits,
            "group_size": int(spec.get("group_size", 64)),
            "percentile": (None if spec.get("percentile") is None
                           else float(spec["percentile"])),
            "calib": spec.get("calib")}


def apply_quantize(model, spec) -> bool:
    """Quantize an InferenceModel per a ``quantize`` spec.  Returns True
    when it quantized here, False when the model already was (its width
    wins; a different requested width is logged).  int8 on a float model
    REQUIRES calibration data (``calib``: .npy one batch, or .npz one
    batch per entry) and fails construction without it."""
    spec = resolve_quantize_spec(spec)
    if spec is None:
        return False
    have = quantized_bits(getattr(model, "_params", None) or {})
    if have:
        if have != spec["bits"]:
            logger.warning(
                "serving: model already quantized at %d bits; ignoring "
                "the quantize=%d config (re-load float weights to "
                "re-quantize)", have, spec["bits"])
        return False
    calib = None
    if spec["calib"]:
        loaded = np.load(spec["calib"], allow_pickle=False)
        calib = [loaded[k] for k in loaded.files] \
            if hasattr(loaded, "files") else loaded
    if spec["bits"] == 8 and calib is None:
        raise ValueError(
            "quantize: int8 needs activation calibration — provide "
            "quantize.calib (.npy/.npz batch file) or quantize offline "
            "with do_quantize(batches, bits=8)")
    model.do_quantize(calib, force=True, bits=spec["bits"],
                      group_size=spec["group_size"],
                      percentile=spec["percentile"])
    logger.info("serving: model quantized to int%d at construction "
                "(group_size=%d, percentile=%s, calib=%s)", spec["bits"],
                spec["group_size"], spec["percentile"], spec["calib"])
    return True


# ServingParams options of the JAX engine that this slice does not serve:
# name -> the value that means "off".  Any other value raises.
_NOT_PORTED = {"sharding": "off", "mesh_shape": None,
               "compile_cache_dir": None}


class ServingParams:
    """config.yaml ``params:`` surface: the JAX engine's ``ServingParams``,
    with its parameters in the same positional order.  The options listed
    in ``_NOT_PORTED`` raise when set to anything but their "off" value."""

    def __init__(self, batch_size: int = 4, top_n: int = 5,
                 poll_timeout_s: float = 0.05, stream_max_len: int = 100000,
                 filter_threshold: Optional[float] = None,
                 write_retries: int = 5, write_backoff_s: float = 0.05,
                 pipeline_depth: int = 2,
                 max_worker_restarts: int = 5,
                 worker_backoff_s: float = 0.05,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 0.5,
                 http_port: Optional[int] = None,
                 http_host: str = "127.0.0.1",
                 drain_s: Optional[float] = None,
                 ready_queue_depth: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 preprocess_workers: int = 1,
                 inflight_batches: int = 2,
                 trim_interval_s: float = 5.0,
                 tracing: bool = True,
                 replica_id: Optional[str] = None,
                 lease_s: float = 30.0,
                 reclaim_interval_s: Optional[float] = None,
                 max_deliveries: int = 5,
                 mesh_shape=None,
                 sharding: str = "off",
                 gateway: bool = True,
                 warmup=False,
                 compile_cache_dir: Optional[str] = None,
                 generation=None,
                 trace_sample: float = 1.0,
                 serving_slo=None,
                 quantize=None,
                 flight_recorder: bool = True,
                 recorder_ring: Optional[int] = None,
                 profiling: bool = True,
                 model_version: Optional[str] = None,
                 faults=None,
                 admission=None,
                 brownout=None,
                 metering=None):
        given = locals()
        for key, off in _NOT_PORTED.items():
            if given[key] != off:
                raise NotImplementedError(
                    f"ServingParams.{key}={given[key]!r}: not ported yet")
        self.batch_size = batch_size
        self.top_n = top_n
        # kept for config parity; the JAX engine stores it unused too
        self.filter_threshold = filter_threshold
        self.poll_timeout_s = poll_timeout_s
        self.stream_max_len = stream_max_len
        self.write_retries = write_retries
        self.write_backoff_s = write_backoff_s
        # staged micro-batches between preprocess and the generate worker;
        # bounds memory AND provides backpressure
        self.pipeline_depth = pipeline_depth
        self.max_worker_restarts = max_worker_restarts
        self.worker_backoff_s = worker_backoff_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        # the probe port (0 picks an ephemeral one; None = no HTTP server)
        self.http_port = http_port
        self.http_host = http_host
        self.drain_s = drain_s
        self.ready_queue_depth = ready_queue_depth
        # coalescing read: up to max_batch records (None = batch_size),
        # waiting at most max_wait_ms once a partial batch has arrived
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.preprocess_workers = preprocess_workers
        # predict plane: bound on dispatched batches queued between the
        # predict and write workers (clamped to the model's
        # supported_concurrent_num at start)
        self.inflight_batches = inflight_batches
        self.trim_interval_s = trim_interval_s
        self.tracing = bool(tracing)
        # the ingestion gateway's /v1 routes on the probe port; off = a
        # probe-only port
        self.gateway = bool(gateway)
        # horizontal replicas: identity, lease, reclaim period, poison
        # parking after max_deliveries
        self.replica_id = replica_id
        self.lease_s = lease_s
        self.reclaim_interval_s = reclaim_interval_s
        self.max_deliveries = int(max_deliveries)
        # generation plane: None (the predict plane) | True (defaults) |
        # a dict of serving/generate.GenerationParams keys
        self.generation = generation if isinstance(generation, dict) \
            else ({} if generation else None)
        try:
            self.trace_sample = min(max(float(trace_sample), 0.0), 1.0)
        except (TypeError, ValueError):
            self.trace_sample = 1.0
        # SLO attribution: {"latency_ms", "window_s", "target"} or None
        self.serving_slo = serving_slo if isinstance(serving_slo, dict) \
            else None
        # quantized predict: None (float) | "int8"/8 | "int4"/4 | a dict
        # {"bits", "group_size", "percentile", "calib"}, applied at
        # ClusterServing construction
        self.quantize = resolve_quantize_spec(quantize)
        self.flight_recorder = bool(flight_recorder)
        self.recorder_ring = (None if recorder_ring is None
                              else max(16, int(recorder_ring)))
        # POST /debug/profile on the probe port (one torch.profiler trace
        # at a time); off removes the route
        self.profiling = bool(profiling)
        self.model_version = (None if model_version is None
                              else str(model_version))
        # ahead-of-time warm-up at start: False | True (derive the set) |
        # a predict spec {"shape", "dtype", "scales", "max_batch",
        # "scale_dtypes"} (inference/aot.resolve_manifest)
        self.warmup = warmup if isinstance(warmup, dict) else bool(warmup)
        # fault injection (serving/faults.py): strictly opt-in chaos, each
        # point gated on model_version
        self.faults = faults if isinstance(faults, dict) else None
        # overload armour: the tenant admission gate the gateway consults
        # (serving/admission.py: enabled, rate, burst, tenants,
        # depth_fractions) and the brownout ladder driven by the SLO burn
        # rate (serving/brownout.py: enter, exit_ratio, dwell_s, hold_s,
        # batch_max_tokens; it needs serving_slo for its input).  None =
        # off
        self.admission = admission if isinstance(admission, dict) else None
        self.brownout = brownout if isinstance(brownout, dict) else None
        # usage metering (serving/metering.py): None/True = on with
        # defaults ({tenant=,model=} series, per-interval usage deltas,
        # per-tenant SLO views); a dict configures it ({"enabled",
        # "max_tenants", "slo_objectives"}); False = the unlabelled
        # records/tokens series only
        if isinstance(metering, dict):
            self.metering = metering
        elif metering is None:
            self.metering = {}
        else:
            self.metering = {} if metering else {"enabled": False}

    @classmethod
    def from_dict(cls, p: Dict) -> "ServingParams":
        """The config.yaml ``params:`` section; an unknown key raises."""
        return cls(**dict(p))

    @staticmethod
    def from_yaml(path: str) -> "ServingParams":
        import yaml
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        return ServingParams.from_dict(cfg.get("params", {}))


class ClusterServing:
    """The serving engine over one ``InferenceModel`` and one queue: the
    predict plane, or generation when ``params.generation`` is set."""

    def __init__(self, model, queue: BaseQueue,
                 params: Optional[ServingParams] = None,
                 preprocess: Callable = default_preprocess,
                 postprocess: Optional[Callable] = None,
                 tensorboard_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if tensorboard_dir is not None:
            raise NotImplementedError(
                "ClusterServing(tensorboard_dir=...): TensorBoard summaries "
                "(utils/tbwriter.py) are not ported yet (ROADMAP queue 1, "
                "item 6)")
        self.model = model
        self.queue = queue
        self.params = params or ServingParams()
        p = self.params
        # fault injection: built even when inert (describe() rides the
        # health document); a point is wired in only when armed for this
        # replica's version (admission_reject fires in the admission gate)
        self._faults = FaultInjector(p.faults, p.model_version)
        # quantize BEFORE any worker can dispatch: a bad spec (int8 with
        # no calibration) fails construction, not a mid-stream request
        if p.quantize and isinstance(model, InferenceModel):
            apply_quantize(model, p.quantize)
        self.preprocess = preprocess
        self.postprocess = postprocess or (
            lambda probs: default_postprocess(probs, self.params.top_n))
        self._stop = threading.Event()
        self._draining = threading.Event()   # graceful drain in progress
        # decommission drain: stop CLAIMING, flush what is held, leave the
        # shared queue open for the surviving replicas
        self._retiring = threading.Event()
        self.total_records = 0
        self.dead_lettered = 0
        self.shed = 0
        self.replica_id = p.replica_id or \
            f"replica-{os.getpid()}-{new_trace_id()[:6]}"
        self.model_version = p.model_version
        self.reclaimed = 0
        self.duplicates = 0
        self._last_reclaim = 0.0             # monotonic; 0 = sweep at start
        self._redelivered: Dict[str, int] = {}   # rid -> delivery count
        # rid -> monotonic claim ts for records in OUR pipeline: the
        # reclaim sweep must not mistake our own slow work for orphans
        self._inflight: Dict[str, float] = {}
        self._hb_ts = time.monotonic()       # read-loop heartbeat stamp
        self._t_construct = time.monotonic()
        self._t_start = time.monotonic()
        self._cold_start_s: Optional[float] = None
        self._warm_state: Dict = {"state": "off", "total": 0,
                                  "compiled": 0, "failed": 0,
                                  "seconds": None}
        self._warm_thread: Optional[threading.Thread] = None
        self._snapshot_seq = itertools.count(1)
        try:
            self.queue.consumer = self.replica_id
        except Exception:  # noqa: BLE001 — exotic custom backend
            pass
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or Tracer()
        if self.tracer.replica_id is None:
            self.tracer.replica_id = self.replica_id
        # trace_id -> (parent span id, sampled) from the record's trace_ctx
        self._trace_meta: Dict[str, Tuple[Optional[str], bool]] = {}
        self._qwait: Dict[str, float] = {}   # rid -> queue-wait seconds
        self._span = (self._record_span if p.tracing
                      else (lambda *a, **kw: None))
        self._slo = SloTracker.from_config(self.registry, p.serving_slo)
        self.recorder = get_recorder()
        if p.recorder_ring:
            self.recorder.resize(p.recorder_ring)
        self._event = (self._record_event if p.flight_recorder
                       else (lambda *a, **kw: None))
        # overload armour: the brownout ladder (fed the SLO burn rate by
        # the read loop) and the tenant admission gate the gateway consults
        # per request; None wires nothing into the hot path
        self._brownout = None
        self._brownout_next = 0.0            # next ladder tick (throttled)
        if p.brownout is not None:
            self._brownout = BrownoutLadder(
                p.brownout,
                recorder=self.recorder if p.flight_recorder else None,
                registry=self.registry, replica_id=self.replica_id)
        self._admission = None
        if p.admission is not None:
            self._admission = AdmissionController(
                p.admission, registry=self.registry,
                queue_depth_fn=self._admission_depth,
                max_depth=getattr(queue, "max_depth", None),
                brownout_stage_fn=lambda: self.brownout_stage,
                faults=self._faults)
        # smoothed per-batch predict time: the early-drop gate's estimate
        # (None until the first batch lands: never drop on a guess)
        self._predict_ewma_s: Optional[float] = None
        # the scheduler-side armour (priority-ordered claim and shed, the
        # deadline early drop) rides the same opt-in as the config blocks
        self._armor = p.admission is not None or p.brownout is not None
        # on-demand profiling: one torch.profiler trace at a time, written
        # under profile_dir (set by the engine's owner; a temporary
        # directory otherwise)
        self.profile_dir: Optional[str] = None
        self._http = None                    # HealthServer when http_port set
        # live retune: validated knob targets staged by retune() and applied
        # at the preprocess loop's batch boundary, by the thread that owns
        # the read batch and the preprocess pool
        self._knob_lock = threading.Lock()
        self._pending_knobs: Dict[str, float] = {}
        self._write_retry = RetryPolicy(max_retries=p.write_retries,
                                        base_delay_s=p.write_backoff_s)
        self._breaker = CircuitBreaker(failure_threshold=p.breaker_threshold,
                                       cooldown_s=p.breaker_cooldown_s,
                                       name="result-write")
        # a separate breaker for dead-letter writes, so a succeeding
        # put_error cannot reset the put_result failure streak
        self._dead_breaker = CircuitBreaker(
            failure_threshold=p.breaker_threshold,
            cooldown_s=p.breaker_cooldown_s, name="dead-letter-write")
        self._pre_sup: Optional[SupervisedThread] = None
        self._gen_sup: Optional[SupervisedThread] = None      # generation
        self._predict_sup: Optional[SupervisedThread] = None  # predict
        self._write_sup: Optional[SupervisedThread] = None    # predict
        self._staged: Optional[Queue] = None
        self._writeq: Optional[Queue] = None
        self._pre_pool = None
        self._pre_pool_size = 0              # workers in the live pool
        self._last_trim = time.monotonic()
        # the token scheduler, built here so a model lacking the paged
        # decode API fails construction, not a mid-stream request
        self._batcher = None
        self._gen_params = None
        # where checkpoints spool: set after construction by the engine's
        # owner (None disables checkpointing even with an interval set)
        self.snapshot_path: Optional[str] = None
        if p.generation is not None:
            self._gen_params = GenerationParams.from_dict(p.generation)
            self._batcher = ContinuousBatcher(model, self._gen_params)
        if isinstance(model, InferenceModel):
            model.bind_registry(self.registry)
            if self._faults.predict_active:
                # instance-patched: the dispatch keeps a patched
                # do_predict on the path, so the injected failure flows
                # through the real quarantine / bisect machinery
                model.do_predict = self._faults.wrap_predict(
                    model.do_predict)
        self._init_metrics()

    @property
    def _sups(self) -> List[SupervisedThread]:
        return [s for s in (self._pre_sup, self._gen_sup, self._predict_sup,
                            self._write_sup) if s is not None]

    def _init_metrics(self) -> None:
        reg = self.registry
        stage_hist = reg.histogram(
            "serving_stage_seconds",
            "Per-stage latency of the serving pipeline", labels=("stage",))
        self._stages = {name: stage_hist.labels(stage=name) for name in
                        ("read", "preprocess", "stage_wait", "predict",
                         "write")}
        self._e2e = reg.histogram(
            "serving_e2e_seconds",
            "Per-record latency from read_batch return to result written")
        # usage metering: the meter owns the {tenant=,model=} series
        # (serving_records_total, serving_generated_tokens_total,
        # serving_sheds_total, serving_device_seconds_total,
        # serving_request_seconds), or with metering off the unlabelled
        # records and tokens series
        p = self.params
        tenants = ()
        if isinstance(p.admission, dict) \
                and isinstance(p.admission.get("tenants"), dict):
            tenants = tuple(p.admission["tenants"])
        self.meter = UsageMeter(reg, model=self.model_version,
                                cfg=p.metering, tenants_configured=tenants,
                                slo_defaults=p.serving_slo)
        self._m_quarantined = reg.counter(
            "serving_quarantined_total", "Records dead-lettered, by stage",
            labels=("stage",))
        self._m_shed = reg.counter(
            "serving_shed_total", "Deadline-exceeded records shed")
        self._m_wire_bytes = reg.counter(
            "serving_wire_bytes_total",
            "Wire bytes observed at read, by record format",
            labels=("format",))
        for fmt in (_wire.FMT_JSON, _wire.FMT_BIN, _wire.FMT_SHM):
            self._m_wire_bytes.labels(format=fmt).inc(0)
        self._pre_fmt_hist = reg.histogram(
            "serving_preprocess_seconds",
            "Per-record preprocess (decode) latency, by wire format",
            labels=("format",))
        self._m_reclaimed = reg.counter(
            "serving_reclaimed_total",
            "Orphaned records re-claimed from dead replicas, by backend",
            labels=("backend",)).labels(backend=type(self.queue).__name__)
        self._m_reclaimed.inc(0)
        self._m_duplicates = reg.counter(
            "serving_duplicate_results_total",
            "Redelivered records suppressed because a result already "
            "existed")
        self._m_duplicates.inc(0)
        self._hb_gauge = reg.gauge(
            "serving_heartbeat_age_seconds",
            "Seconds since this replica's read loop last made progress",
            labels=("replica",))
        self._hb_gauge.labels(replica=self.replica_id).set_function(
            self._heartbeat_age)
        self._g_cold = reg.gauge(
            "replica_cold_start_seconds",
            "Engine construction to first result written, this replica")
        # the warm-up's phases: `load` the model's load wall, `compile`
        # the warm-up pass (graph captures and dry runs)
        self._g_warm = reg.gauge(
            "serving_warmup_seconds",
            "Replica warm-up wall seconds, by phase", labels=("phase",))
        load_s = getattr(self.model, "load_seconds", None)
        if load_s is not None:
            self._g_warm.labels(phase="load").set(float(load_s))
        # callback gauges, deregistered on shutdown
        fns = [
            ("serving_queue_depth", "Records waiting in the stream",
             self._queue_depth_metric),
            ("serving_dead_letters", "Dead-letter backlog",
             self._dead_letter_metric),
            ("serving_worker_restarts",
             "Supervised-worker restarts across all stages",
             self._restarts_metric),
            ("serving_breaker_trips", "Result-write breaker trips",
             lambda: float(self._breaker.trip_count)),
        ]
        if self._batcher is not None:
            fns += self._init_generation_metrics()
        self._gauge_fns = [(reg.gauge(name, help_, fn=fn), fn)
                           for name, help_, fn in fns]
        # resource accounting: device memory by component (weights at
        # their stored dtype, decode state, CUDA-graph pools), live gauges
        # beside the health document's `resources` block
        self._ledger = ResourceLedger(self.model, batcher=self._batcher)
        hbm = reg.gauge("serving_hbm_bytes",
                        "Device memory by component: weights (stored "
                        "dtype), kv_state (decode state), executables "
                        "(CUDA-graph memory pools)", labels=("component",))
        for comp in ResourceLedger.COMPONENTS:
            fn = (lambda c=comp: self._ledger.hbm_bytes(c))
            child = hbm.labels(component=comp)
            child.add_function(fn)
            self._gauge_fns.append((child, fn))
        for name, help_, key in (
                ("process_resident_memory_bytes",
                 "Resident set size of this serving process", "rss_bytes"),
                ("process_cpu_seconds_total",
                 "User+system CPU seconds consumed by this process",
                 "cpu_seconds"),
                ("process_open_fds",
                 "Open file descriptors in this process", "open_fds"),
                ("process_threads_total",
                 "Live threads in this process", "threads")):
            fn = (lambda k=key: float(process_stats().get(k) or 0))
            self._gauge_fns.append((reg.gauge(name, help_, fn=fn), fn))

    def _init_generation_metrics(self) -> List:
        """The token scheduler's counters; returns its callback gauges."""
        reg = self.registry
        b = self._batcher
        self._m_decode_steps = reg.counter(
            "serving_decode_steps_total",
            "Decode steps executed by the token scheduler")
        self._m_decode_steps.inc(0)
        self._m_ttft = reg.histogram(
            "serving_time_to_first_token_seconds",
            "Request admission to first generated token")
        self._g_tps = reg.gauge(
            "serving_tokens_per_second",
            "Generated tokens per second over the last rate window")
        self._g_tps.set(0.0)
        self._last_steps = 0
        self._tps_window = (time.monotonic(), 0)   # (t0, tokens0)
        # continuity counters, made at zero so deltas are exact
        self._last_resumed = 0
        self._m_resumed = reg.counter(
            "serving_generations_resumed_total",
            "Generations resumed from a dead owner's checkpoint")
        self._m_resumed.inc(0)
        self._m_resume_wasted = reg.counter(
            "serving_resume_wasted_tokens_total",
            "Generated tokens re-computed because a generation restarted "
            "without (or beyond) a usable checkpoint")
        self._m_resume_wasted.inc(0)
        pool = b._pool
        fns = [
            ("serving_active_slots",
             "Decode slots currently serving a request",
             lambda: float(b.active)),
            ("serving_kv_state_bytes",
             "Bytes pinned by decode state (lanes, pool, scales, staging, "
             "host tables)", lambda: float(b.state_bytes())),
        ]
        if pool is not None:
            fns += [
                ("serving_kv_pool_free_blocks",
                 "Free blocks in the paged KV pool",
                 lambda: float(pool.free_blocks)),
                ("serving_kv_pool_occupancy",
                 "Used fraction of the paged KV pool",
                 lambda: float(pool.used_blocks) / max(1, pool.n_blocks))]
        if b._prefix is not None:
            fns.append(("serving_kv_prefix_hits_total",
                        "Prefix-cache hits at admission",
                        lambda: float(b._prefix.hits)))
        return fns

    # -- callback-gauge samplers (guarded: a dead backend yields NaN) --------
    def _queue_depth_metric(self) -> float:
        try:
            return float(self.queue.depth())
        except Exception:  # noqa: BLE001 — backend down
            return float("nan")

    def _dead_letter_metric(self) -> float:
        try:
            return float(self.queue.dead_letter_count())
        except Exception:  # noqa: BLE001
            return float("nan")

    def _restarts_metric(self) -> float:
        return float(sum(s.health()["restart_count"] for s in self._sups))

    def _heartbeat_age(self) -> float:
        return time.monotonic() - self._hb_ts

    # -- overload armour -------------------------------------------------------
    def _admission_depth(self) -> Optional[int]:
        """Queue depth for the admission gate's class caps; None (no
        signal, admit) when the backend is unreachable — a dead backend is
        the breaker's problem, not a reason to 429."""
        try:
            return int(self.queue.depth())
        except Exception:  # noqa: BLE001 — backend down
            return None

    @property
    def brownout_stage(self) -> int:
        return self._brownout.stage if self._brownout is not None else 0

    def admit_record(self, tenant=None, priority=None):
        """The gateway's per-request admission consult.  Returns an
        ``admission.Decision``, or None when no controller is configured
        (the gateway falls through to the queue's fleet-wide 429)."""
        if self._admission is None:
            return None
        d = self._admission.admit(tenant, priority)
        if not d.admitted:
            # rejections belong on the incident timeline next to the
            # brownout transitions they usually accompany
            self._event("admission_reject", reason=d.reason,
                        tenant=d.tenant, priority=d.priority)
        return d

    def _brownout_tick(self) -> None:
        """Feed the ladder the current SLO burn rate (at most 4 Hz: the
        ladder's dwell and hold windows are seconds)."""
        if self._brownout is None or self._slo is None:
            return
        now = time.monotonic()
        if now < self._brownout_next:
            return
        self._brownout_next = now + 0.25
        try:
            burn = self._slo.snapshot().get("burn_rate", 0.0)
        except Exception:  # noqa: BLE001 — ladder input, not load-bearing
            return
        self._brownout.observe(burn, now)

    def _note_predict_time(self, seconds: float) -> None:
        """EWMA of per-batch predict wall time (alpha 0.2) — the early
        drop gate's service-time estimate."""
        if seconds <= 0:
            return
        prev = self._predict_ewma_s
        self._predict_ewma_s = seconds if prev is None \
            else 0.8 * prev + 0.2 * seconds

    def _pressure_level(self) -> int:
        """Engine-side shed aggressiveness (0/1/2) from the staged-buffer
        backlog, the queue-depth fraction and the brownout stage — see
        ``admission.pressure_level``."""
        staged = self._staged
        staged_frac = 0.0
        if staged is not None:
            staged_frac = staged.qsize() / max(1, staged.maxsize or 1)
        depth_frac = 0.0
        max_depth = getattr(self.queue, "max_depth", None)
        if max_depth:
            depth = self._admission_depth()
            if depth is not None:
                depth_frac = depth / float(max_depth)
        return pressure_level(staged_frac, depth_frac, self.brownout_stage)

    # -- flight recorder + tracing -------------------------------------------
    def _record_event(self, kind: str, **attrs) -> None:
        """Stamp replica identity, never raise — forensics must not be able
        to take serving down."""
        try:
            self.recorder.record(kind, replica=self.replica_id, **attrs)
        except Exception:  # noqa: BLE001 — diagnostic, not load-bearing
            pass

    # -- on-demand profiling ---------------------------------------------------
    PROFILE_MIN_S, PROFILE_MAX_S = 0.05, 300.0

    def _device_work(self) -> int:
        """Units of device work this engine has issued so far: decode
        steps on the generation plane, padded forwards on the predict
        plane."""
        if self._batcher is not None:
            return int(self._batcher.decode_steps)
        try:
            return int(sum(self.model.aot_stats()["programs"].values()))
        except Exception:  # noqa: BLE001 — a model without the counters
            return 0

    def start_profile(self, seconds: float,
                      out_dir: Optional[str] = None) -> Dict:
        """Arm one ``torch.profiler`` trace of this process for
        ``seconds`` (clamped to [PROFILE_MIN_S, PROFILE_MAX_S]) into a new
        directory under ``out_dir``, ``profile_dir`` or the temporary
        directory; the Chrome trace lands there as ``trace.json``.  ONE
        trace at a time: a second request while one is armed, or while
        another profiler session of the process records (the profiler
        keeps one session a process; ``ops/_impl.card_launches`` holds
        ``_impl.PROFILER_LOCK`` for its own, as this trace does), raises
        ``RuntimeError`` (the gateway answers 409).

        The trace runs on a daemon thread, so a probe handler never waits
        for it; the 202 reply means "armed".  It records CPU activity and,
        on a CUDA engine, the card's kernels: CUPTI records the device
        across the whole process, while CPU operator events are recorded
        on the profiling thread only, so the trace holds the card's
        kernels and none of the workers' CPU operators.  ``profile_done``
        (with the trace's device and CPU event counts) marks its end.  A trace that fails — it cannot start, or
        a CUDA engine did device work inside the window and the trace
        holds no device event — posts ``profile_error`` instead, and the
        engine serves on."""
        import tempfile
        seconds = min(max(float(seconds), self.PROFILE_MIN_S),
                      self.PROFILE_MAX_S)
        base = out_dir or self.profile_dir or os.path.join(
            tempfile.gettempdir(), f"serving-profile-{self.replica_id}")
        path = os.path.join(
            base, time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}")
        if torch.autograd._profiler_enabled() \
                or not _impl.PROFILER_LOCK.acquire(blocking=False):
            raise RuntimeError(
                "a profiling trace is already armed/running, or another "
                "profiler session records in this process — one at a time")
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            _impl.PROFILER_LOCK.release()
            raise
        self._event("profile_start", path=path, seconds=seconds)
        threading.Thread(target=self._profile_run, args=(path, seconds),
                         name="serving-profile", daemon=True).start()
        logger.info("serving: profiling armed for %.2fs into %s",
                    seconds, path)
        return {"profiling": True, "path": path,
                "seconds": seconds, "replica_id": self.replica_id}

    def _profile_run(self, path: str, seconds: float) -> None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        cuda = getattr(self.model, "device", None) is not None \
            and torch.device(self.model.device).type == "cuda"
        try:
            activities = [ProfilerActivity.CPU]
            if cuda:
                if ProfilerActivity.CUDA not in \
                        torch.profiler.supported_activities():
                    raise RuntimeError("this torch build cannot trace the "
                                       "card (no CUDA profiler activity)")
                activities.append(ProfilerActivity.CUDA)
            # start and stop between decode boundaries: every CUDA-graph
            # replay runs inside a boundary, under the batcher's lock, and
            # stopping the profiler while another thread replayed a graph
            # deadlocked the two on the H100
            quiet = self._batcher._device_lock \
                if self._batcher is not None else contextlib.nullcontext()
            work0 = self._device_work()
            prof = profile(activities=activities)
            with quiet:
                prof.start()
            try:
                time.sleep(seconds)
            finally:
                with quiet:
                    prof.stop()
            work = self._device_work() - work0
            trace = os.path.join(path, "trace.json")
            prof.export_chrome_trace(trace)
            # counted on the raw records: key_averages() would build a
            # Python event for each of them, which for the ~10^5 kernels
            # of a busy second holds the interpreter lock the serving
            # workers need for many seconds
            device = cpu = 0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA:
                    device += 1
                else:
                    cpu += 1
            if cuda and work > 0 and device == 0:
                raise RuntimeError(
                    f"the trace holds no device event although {work} "
                    f"unit(s) of device work ran in its window")
            self._event("profile_done", path=path, seconds=seconds,
                        device_events=device, cpu_events=cpu,
                        device_work=work)
        except Exception as e:  # noqa: BLE001 — the trace failing must not
            # leave the engine permanently "busy", nor take serving down
            logger.exception("serving: profiling trace failed")
            self._event("profile_error",
                        error=f"{type(e).__name__}: {e}"[:200], path=path)
        finally:
            _impl.PROFILER_LOCK.release()

    _TRACE_META_CAP = 8192

    def _record_span(self, stage, t0, t1, trace_id=None, uri=None,
                     error=None, parent_id=None, attrs=None):
        """Head sampling + cross-process parenting.  Error spans bypass
        sampling, so a quarantine in a sampled-out trace stays
        diagnosable."""
        meta = self._trace_meta.get(trace_id) if trace_id else None
        if error is None:
            if meta is not None:
                if not meta[1]:
                    return None
            elif not trace_sampled(trace_id, self.params.trace_sample):
                return None
        if parent_id is None and meta is not None:
            parent_id = meta[0]
        return self.tracer.span(stage, t0, t1, trace_id=trace_id, uri=uri,
                                error=error, parent_id=parent_id,
                                attrs=attrs)

    def _note_trace_ctx(self, rid, rec: Dict, t_claim: float) -> None:
        """Fold a record's propagated ``trace_ctx`` in: remember (parent
        span id, sampled) for the span wrapper, and record the QUEUE-WAIT
        span from the stamped ingest time.  Absent or malformed context
        degrades to no parent and no queue-wait span."""
        tc = rec.get("trace_ctx")
        if not isinstance(tc, dict):
            return
        tid = rec.get("trace_id")
        ctx = SpanContext.from_traceparent(tc.get("tp"))
        if ctx is not None:
            if tid is None:
                tid = rec["trace_id"] = ctx.trace_id
            if len(self._trace_meta) >= self._TRACE_META_CAP:
                for k in list(self._trace_meta)[: self._TRACE_META_CAP // 2]:
                    self._trace_meta.pop(k, None)
            self._trace_meta[tid] = (ctx.span_id, ctx.sampled)
        ts = tc.get("ts")
        if isinstance(ts, (int, float)) and 0 < ts < float("inf"):
            # clamp pathological producer clock skew to an hour
            wait_s = min(max((time.time_ns() - ts) / 1e9, 0.0), 3600.0)
            self._qwait[rid] = wait_s
            if len(self._qwait) > self._TRACE_META_CAP:
                for k in list(self._qwait)[: self._TRACE_META_CAP // 2]:
                    self._qwait.pop(k, None)
            self._span("queue_wait", t_claim - wait_s, t_claim,
                       trace_id=tid, uri=rid)

    def _slo_observe(self, rid, e2e_s: float,
                     stages: Optional[Dict] = None,
                     tenant: Optional[str] = None) -> float:
        """Feed one completed record to the SLO tracker and the tenant's
        burn view, queue-wait folded in as a stage and into the judged
        latency.  Returns the folded e2e, which the caller charges to
        ``serving_request_seconds`` once per (tenant, flush)."""
        qwait = self._qwait.pop(rid, None)
        stages = dict(stages or {})
        if qwait is not None:
            stages["queue_wait"] = qwait
            e2e_s = float(e2e_s) + qwait
        self.meter.slo_observe(tenant, e2e_s, stages)
        if self._slo is not None:
            self._slo.observe(e2e_s, stages)
        return float(e2e_s)

    # -- lease lifecycle ------------------------------------------------------
    def _ack(self, rids: List[str]) -> None:
        """Release the claim on fully-handled records.  A failed ack is not
        an error path: the records stay pending and are redelivered after
        the lease; duplicate suppression keeps the result set exact."""
        if not rids:
            return
        for rid in rids:
            self._inflight.pop(rid, None)
        try:
            self.queue.ack(list(rids))
        except Exception as e:  # noqa: BLE001 — backend down mid-ack
            logger.warning(
                "serving: ack failed for %d record(s) (%s: %s); they will "
                "be redelivered after the lease", len(rids),
                type(e).__name__, e)

    def _maybe_reclaim(self) -> List[Tuple[str, Dict]]:
        """Periodic reclaim sweep: re-claim records whose lease expired on
        a dead replica and feed them into the normal pipeline.  Records
        that already have a terminal result are acked and suppressed; a
        streamed PARTIAL is not terminal, so its record is re-served."""
        p = self.params
        if p.lease_s is None or p.lease_s <= 0:
            return []
        interval = p.reclaim_interval_s if p.reclaim_interval_s is not None \
            else max(p.lease_s / 2.0, 0.05)
        now = time.monotonic()
        if now - self._last_reclaim < interval:
            return []
        self._last_reclaim = now
        try:
            entries = self.queue.reclaim(
                p.lease_s, max_items=p.max_batch or p.batch_size)
        except Exception as e:  # noqa: BLE001 — backend down: next sweep
            logger.warning("serving: reclaim sweep failed (%s: %s)",
                           type(e).__name__, e)
            return []
        if not entries:
            return []
        # self-reclaim guard: our own in-flight records can outlive the
        # lease too; the queue already refreshed their lease under our
        # name.  Entries older than the stale bound count as abandoned.
        stale_s = max(p.lease_s * 10.0, p.lease_s + 60.0)
        for rid, ts in list(self._inflight.items()):
            if now - ts > stale_s:
                self._inflight.pop(rid, None)
        entries = [e for e in entries if e[0] not in self._inflight]
        if not entries:
            return []
        self.reclaimed += len(entries)
        self._m_reclaimed.inc(len(entries))
        try:
            existing = self.queue.get_results([rid for rid, _, _ in entries])
        except Exception:  # noqa: BLE001 — store down: skip suppression
            existing = {}
        out: List[Tuple[str, Dict]] = []
        t = time.monotonic()
        for rid, rec, deliveries in entries:
            tid = rec.get("trace_id") if isinstance(rec, dict) else None
            self._span("reclaim", t, t, trace_id=tid, uri=rid)
            prior = existing.get(rid)
            partial_n = 0
            if isinstance(prior, dict) and prior.get("partial"):
                # a streamed PARTIAL is not terminal: the owner died
                # mid-generation, so the record is re-served; its token
                # count is the waste a resume tries to recover
                try:
                    partial_n = int(prior.get("n") or 0)
                except (TypeError, ValueError):
                    partial_n = 0
                prior = None
            if prior is not None:
                self.duplicates += 1
                self._m_duplicates.inc()
                self._ack([rid])
                continue
            if isinstance(rec, dict):
                rec["deliveries"] = deliveries
            if 0 < p.max_deliveries < deliveries:
                # poison-pill parking: a record that keeps getting
                # redelivered goes to the dead-letter queue
                self._quarantine(
                    rid, "reclaim",
                    RuntimeError(f"max-deliveries-exceeded: delivery "
                                 f"{deliveries} > max_deliveries="
                                 f"{p.max_deliveries}"),
                    record=rec if isinstance(rec, dict) else None,
                    trace_id=tid)
                continue
            self._redelivered[rid] = deliveries
            if self._batcher is not None and isinstance(rec, dict):
                # attach the dead owner's checkpointed resume state, or
                # count the restart's waste
                resume = self._load_resume(rid, rec, partial_n)
                if resume is not None:
                    rec["_resume"] = resume
            out.append((rid, rec))
        if len(self._redelivered) > 4096:
            for rid in list(self._redelivered):
                if len(self._redelivered) <= 2048:
                    break
                if rid not in self._inflight:
                    self._redelivered.pop(rid, None)
        if out:
            logger.info("serving: replica %s reclaimed %d orphaned "
                        "record(s)", self.replica_id, len(out))
            self._event("reclaim", count=len(out),
                        suppressed=len(entries) - len(out))
        return out

    # -- generation continuity -------------------------------------------------
    def _load_resume(self, rid: str, rec: Dict,
                     partial_n: int) -> Optional[Dict]:
        """Recover the dead owner's checkpointed decode state for one
        reclaimed generation record: follow the lease annotation to its
        snapshot spool, pick the deepest checkpoint of the matching epoch,
        and verify its integrity stamp.  Any failure falls back LOUDLY to
        restart-from-0 (a ``gen_resume_failed`` event) and counts the
        streamed progress the restart throws away; a success records
        ``gen_resume`` and counts only the partial's tail past the
        checkpoint."""
        if not self._gen_params.resume:
            # resume off: the restart recomputes every token the dead
            # owner already streamed
            if partial_n > 0:
                self._m_resume_wasted.inc(partial_n)
            return None
        try:
            ann = self.queue.annotation(rid)
        except Exception:  # noqa: BLE001 — backend hiccup: restart
            ann = None
        if not isinstance(ann, dict) or not ann.get("spool"):
            if partial_n > 0:
                self._m_resume_wasted.inc(partial_n)
                self._event("gen_resume_failed", rid=rid,
                            reason="no-annotation", wasted=partial_n)
            return None
        spool = str(ann["spool"])
        epoch = int(ann.get("epoch") or 0)
        best = None
        try:
            paths = [path for path in (spool, spool + ".1")
                     if os.path.exists(path)]
            for snap in tracecollect.load_snapshots(paths):
                if snap.get("rid") != rid \
                        or int(snap.get("epoch") or 0) != epoch:
                    continue
                if best is None \
                        or int(snap.get("n") or 0) > int(best["n"] or 0):
                    best = snap
        except Exception:  # noqa: BLE001 — unreadable spool: restart
            best = None
        reason = None
        if best is None:
            reason = "no-snapshot"
        else:
            try:
                crc = int(best.get("crc"))
            except (TypeError, ValueError):
                crc = None
            if crc != tracecollect.snapshot_checksum(best):
                reason = "checksum-mismatch"
        tid = rec.get("trace_id")
        if reason is not None:
            self._m_resume_wasted.inc(partial_n)
            self._event("gen_resume_failed", rid=rid, trace_id=tid,
                        reason=reason, wasted=partial_n)
            return None
        n = int(best.get("n") or 0)
        wasted = max(0, partial_n - n)
        if wasted:
            self._m_resume_wasted.inc(wasted)
        self._event("gen_resume", rid=rid, trace_id=tid, epoch=epoch,
                    resumed_tokens=n, wasted=wasted,
                    from_replica=ann.get("replica"))
        return {"tokens": [int(t) for t in best.get("tokens") or []],
                "epoch": epoch + 1}

    # -- result writes --------------------------------------------------------
    def _put_result(self, rid, value):
        """Retry with backoff behind a circuit breaker — a dead result store
        fails fast instead of grinding every write through the schedule."""
        self._breaker.call(self._write_retry.call,
                           self.queue.put_result, rid, value)

    def _flush_results(self, pairs: List[Tuple[str, Dict]],
                       tmap: Optional[Dict] = None,
                       tenmap: Optional[Dict] = None) -> int:
        """Write a group of results in one backend round-trip, falling back
        to per-record writes (``put_result`` is idempotent per key) when the
        batch write fails; only records that individually fail are
        quarantined.  Records served are charged here, the one choke point
        both planes flush through, per tenant (``tenmap``: rid -> tenant),
        so exactly the committed results are billed."""
        if not pairs:
            return 0
        tenmap = tenmap or {}
        try:
            self._breaker.call(self._write_retry.call,
                               self.queue.put_results, pairs)
            self._ack([rid for rid, _ in pairs])
            # one charge per tenant per flush, not per record
            by_tenant: Dict[Optional[str], int] = {}
            for rid, _ in pairs:
                ten = tenmap.get(rid)
                by_tenant[ten] = by_tenant.get(ten, 0) + 1
            for ten, n in by_tenant.items():
                self.meter.records(ten, n)
            return len(pairs)
        except Exception as e:  # noqa: BLE001 — batch path down: degrade
            if not isinstance(e, CircuitBreakerOpen):
                logger.warning(
                    "serving: batched result write failed (%s: %s); "
                    "falling back to per-record writes",
                    type(e).__name__, e)
            written: List[str] = []
            for rid, value in pairs:
                try:
                    self._put_result(rid, value)
                    written.append(rid)
                    self.meter.records(tenmap.get(rid))
                except Exception as rec_exc:  # noqa: BLE001
                    self._quarantine(rid, "put_result", rec_exc,
                                     trace_id=(tmap or {}).get(rid),
                                     tenant=tenmap.get(rid))
            self._ack(written)
            return len(written)

    def _quarantine(self, rid, stage: str, exc: BaseException,
                    record: Optional[Dict] = None,
                    trace_id: Optional[str] = None,
                    tenant: Optional[str] = None):
        """Per-record fault isolation: the poisoned record gets an error
        RESULT plus a dead-letter entry; the rest proceeds untouched.  The
        loss is billed to the record's tenant."""
        self.dead_lettered += 1
        self._m_quarantined.labels(stage=stage).inc()
        if tenant is None and record is not None:
            tenant = record.get("tenant")
        self.meter.sheds(tenant)
        msg = f"{stage}: {type(exc).__name__}: {exc}"
        if trace_id is None and record is not None:
            trace_id = record.get("trace_id")
        now = time.monotonic()
        self._span(stage, now, now, trace_id=trace_id, uri=rid, error=msg,
                   attrs=({"tenant": tenant} if tenant else None))
        logger.warning("serving: quarantining record %r (%s)", rid, msg)
        self._event("quarantine", rid=str(rid), stage=stage,
                    error=msg[:200], trace_id=trace_id, tenant=tenant)
        handled = False
        try:
            self._dead_breaker.call(self.queue.put_error, rid, msg,
                                    record=record, trace_id=trace_id)
            handled = True
        except CircuitBreakerOpen:
            logger.warning("serving: dead-letter write for %r skipped "
                           "(breaker open)", rid)
        except Exception:  # noqa: BLE001 — best-effort: queue may be down
            logger.exception("serving: dead-letter write for %r failed", rid)
        self._redelivered.pop(rid, None)
        if handled:
            self._ack([rid])
        else:
            # terminal write failed: keep the claim pending so the record
            # is redelivered after the lease instead of silently lost
            self._inflight.pop(rid, None)

    # -- deadlines ------------------------------------------------------------
    def _shed_expired(self, rid, rec: Optional[Dict],
                      deadline_ns=None, stage: str = "read",
                      trace_id: Optional[str] = None,
                      tenant: Optional[str] = None) -> bool:
        """True when the deadline — the record's ``deadline_ns``, or the
        one given — has passed (a ``deadline-exceeded`` marker is
        written, the shed billed to the tenant) or is junk
        (quarantined)."""
        dl = deadline_ns if deadline_ns is not None \
            else (rec or {}).get("deadline_ns")
        if dl is None:
            return False
        if trace_id is None and rec is not None:
            trace_id = rec.get("trace_id")
        try:
            expired = time.time_ns() > int(dl)
        except (TypeError, ValueError, OverflowError) as e:
            self._quarantine(rid, stage, e, record=rec, trace_id=trace_id)
            return True
        if not expired:
            return False
        if tenant is None and rec is not None \
                and isinstance(rec.get("tenant"), str):
            tenant = rec.get("tenant")
        self._shed_terminal(rid, stage=stage, trace_id=trace_id,
                            tenant=tenant)
        return True

    def _shed_terminal(self, rid, stage: str = "read",
                       trace_id: Optional[str] = None,
                       error: str = "deadline-exceeded: budget elapsed "
                                    "before predict",
                       extra: Optional[Dict] = None,
                       tenant: Optional[str] = None) -> None:
        """Terminal shed: error marker written (best-effort), claim
        released, counters and span recorded, the loss billed to the
        tenant.  ``extra`` rides the marker (a mid-generation shed keeps
        its partial tokens)."""
        self.shed += 1
        self._m_shed.inc()
        self.meter.sheds(tenant)
        now = time.monotonic()
        self._span(stage, now, now, trace_id=trace_id, uri=rid, error=error,
                   attrs=({"tenant": tenant} if tenant else None))
        self._event("shed", rid=str(rid), stage=stage, trace_id=trace_id,
                    tenant=tenant)
        result = {"error": error}
        if extra:
            result.update(extra)
        if trace_id is not None:
            result["trace_id"] = trace_id
        try:
            self._put_result(rid, result)
        except Exception:  # noqa: BLE001 — store down: client's own
            pass           # deadline still unblocks it
        self._redelivered.pop(rid, None)
        self._ack([rid])

    def _claim_shed(self, rid, rec, to_shed) -> bool:
        """The claim gates of an armoured deployment.  True when the record
        left the pipeline: its priority class is being shed at the current
        pressure level, or the deadline early drop judged it unmeetable —
        remaining budget shorter than the estimated wait through the
        staged backlog at the smoothed per-batch time (no estimate yet =
        never drop)."""
        if not isinstance(rec, dict):
            return False
        trace_id = rec.get("trace_id")
        tenant = rec.get("tenant") \
            if isinstance(rec.get("tenant"), str) else None
        if to_shed:
            prio = normalize_priority(rec.get("priority"))
            if prio in to_shed:
                self._shed_terminal(
                    rid, stage="claim", trace_id=trace_id,
                    error=f"shed: {prio} class dropped under overload "
                          f"pressure", tenant=tenant)
                return True
        dl = rec.get("deadline_ns")
        if dl is not None and self._predict_ewma_s:
            try:
                remaining_s = (int(dl) - time.time_ns()) / 1e9
            except (TypeError, ValueError, OverflowError):
                return False     # junk deadline: _shed_expired's business
            backlog = sum(q.qsize() for q in (self._staged, self._writeq)
                          if q is not None)
            if deadline_unmeetable(remaining_s, backlog,
                                   self._predict_ewma_s):
                self._shed_terminal(
                    rid, stage="claim", trace_id=trace_id,
                    error="deadline-unmeetable: estimated queue wait "
                          "exceeds the remaining budget", tenant=tenant)
                return True
        return False

    # -- read + preprocess ----------------------------------------------------
    def _read_coalesced(self):
        """Pull up to ``max_batch`` records; once a PARTIAL batch has
        arrived keep reading for at most ``max_wait_ms`` to fill it.  An
        idle stream still returns within ``poll_timeout_s``."""
        p = self.params
        max_batch = p.max_batch or p.batch_size
        batch = self.queue.read_batch(max_batch, p.poll_timeout_s)
        if not batch or len(batch) >= max_batch or p.max_wait_ms <= 0:
            return batch
        deadline = time.monotonic() + p.max_wait_ms / 1000.0
        while len(batch) < max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            more = self.queue.read_batch(max_batch - len(batch),
                                         min(remaining, p.poll_timeout_s))
            if more:
                batch.extend(more)
        return batch

    @staticmethod
    def _stack_group(ids, items, deadlines, traces, t_read, metas):
        """Stack one same-shape group into a staged micro-batch: an
        all-int8 group stays compact with per-row scales (dequantized on
        the device), a mixed group is dequantized on the host."""
        t_ready = time.monotonic()
        if all(isinstance(it, QuantizedTensor) for it in items):
            tensors = np.stack([it.data for it in items])
            scales = np.asarray([it.scale for it in items], np.float32)
            return _Staged(ids, tensors, scales, deadlines, traces, t_read,
                           t_ready, metas)
        tensors = np.stack([
            it.data.astype(np.float32) * it.scale
            if isinstance(it, QuantizedTensor) else it for it in items])
        return _Staged(ids, tensors, None, deadlines, traces, t_read,
                       t_ready, metas)

    def _preprocess_pool(self):
        """Thread pool for ``preprocess_workers > 1``; None = inline."""
        if self.params.preprocess_workers <= 1:
            return None
        if self._pre_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pre_pool_size = self.params.preprocess_workers
            self._pre_pool = ThreadPoolExecutor(
                max_workers=self._pre_pool_size,
                thread_name_prefix="serving-pre")
        return self._pre_pool

    # -- live retune -----------------------------------------------------------
    MAX_PREPROCESS_WORKERS = 32

    def retune(self, max_batch: Optional[int] = None,
               max_wait_ms: Optional[float] = None,
               preprocess_workers: Optional[int] = None,
               inflight_batches: Optional[int] = None) -> Dict:
        """Stage a live data-plane retune (an autoscaler's fast tier).
        Values are validated and clamped HERE — ``max_batch`` to the pow-2
        bucket ladder within [1, the model's max_batch],
        ``inflight_batches`` to the model's concurrency contract,
        ``preprocess_workers`` to [1, MAX_PREPROCESS_WORKERS] — and applied
        by the preprocess worker at its next batch boundary, so a
        mid-batch nudge never tears the pipeline.  A predict bucket past
        the warmed ladder runs its first call cold (counted in
        ``InferenceModel.aot_stats()["compiles"]``).  Returns the clamped
        targets.  Safe to call before ``start()``."""
        from analytics_zoo_tpu_torch.inference.inference_model import \
            _pow2_floor
        staged: Dict[str, float] = {}
        if max_batch is not None:
            mb = _pow2_floor(max(1, int(max_batch)))
            cap = getattr(self.model, "max_batch", None)
            if cap is not None:
                mb = min(mb, int(cap))
            staged["max_batch"] = mb
        if max_wait_ms is not None:
            staged["max_wait_ms"] = max(0.0, float(max_wait_ms))
        if preprocess_workers is not None:
            staged["preprocess_workers"] = min(
                max(1, int(preprocess_workers)), self.MAX_PREPROCESS_WORKERS)
        if inflight_batches is not None:
            inflight = max(1, int(inflight_batches))
            model_cap = getattr(self.model, "concurrent_num", None)
            if model_cap is not None:
                inflight = min(inflight, int(model_cap))
            staged["inflight_batches"] = inflight
        with self._knob_lock:
            self._pending_knobs.update(staged)
        return staged

    def knobs(self) -> Dict:
        """Current data-plane knob targets (pending retunes win over the
        applied params)."""
        p = self.params
        doc = {"max_batch": p.max_batch or p.batch_size,
               "max_wait_ms": p.max_wait_ms,
               "preprocess_workers": p.preprocess_workers,
               "inflight_batches": p.inflight_batches,
               "max_batch_ceiling": int(getattr(self.model, "max_batch",
                                                1024) or 1024),
               "inflight_ceiling": int(getattr(self.model, "concurrent_num",
                                               None) or 64)}
        with self._knob_lock:
            doc.update(self._pending_knobs)
        return doc

    def _apply_pending_knobs(self) -> None:
        """Apply staged retunes on the preprocess worker between
        micro-batches: ``max_batch``/``max_wait_ms`` are read per batch by
        ``_read_coalesced``, the pool swap happens with no decode in
        flight, and the write-queue resize changes ``maxsize`` under the
        queue's own mutex."""
        with self._knob_lock:
            if not self._pending_knobs:
                return
            staged, self._pending_knobs = self._pending_knobs, {}
        p = self.params
        if "max_batch" in staged:
            p.max_batch = int(staged["max_batch"])
        if "max_wait_ms" in staged:
            p.max_wait_ms = float(staged["max_wait_ms"])
        if "preprocess_workers" in staged:
            p.preprocess_workers = int(staged["preprocess_workers"])
            if self._pre_pool is not None and \
                    self._pre_pool_size != p.preprocess_workers:
                # no decode in flight at the batch boundary: the old pool
                # has nothing queued, so the swap is clean
                self._pre_pool.shutdown(wait=False)
                self._pre_pool = None
        if "inflight_batches" in staged:
            p.inflight_batches = int(staged["inflight_batches"])
            q = self._writeq
            if q is not None:
                with q.mutex:
                    q.maxsize = p.inflight_batches
                    q.not_full.notify_all()
        logger.info("serving: replica %s retuned %s", self.replica_id,
                    staged)
        self._event("retune", **{k: float(v) for k, v in staged.items()})

    def _read_and_preprocess(self):
        """Read one micro-batch (reclaimed orphans first) and preprocess it
        record by record, returning a LIST of staged groups, one per prompt
        shape.  A malformed record quarantines alone.  None = the stream
        was empty; [] = records were read but all shed or quarantined."""
        t0 = time.monotonic()
        self._hb_ts = t0
        self._apply_pending_knobs()
        # the brownout ladder's tick: the SLO burn rate in, so the stage
        # the gateway and the scheduler consult tracks the live window
        self._brownout_tick()
        if self._faults.claim_active:
            # claim_stall: a deterministic backlog builder — the read loop
            # stalls BEFORE claiming
            stall = self._faults.take_claim_stall()
            if stall > 0.0:
                self._event("claim_stall", state=f"{stall:g}s")
                self._stop.wait(stall)
        if self._retiring.is_set():
            return None
        batch = self._maybe_reclaim()
        batch += self._read_coalesced()
        t_read = time.monotonic()
        if not batch:
            return None
        self._stages["read"].record(t_read - t0)
        bytes_by_tenant: Dict[Optional[str], int] = {}
        for rid, rec in batch:
            self._inflight[rid] = t_read
            self._note_trace_ctx(rid, rec, t_read)
            rec.setdefault("trace_id", new_trace_id())
            nbytes = rec.get("wire_bytes")
            if not (isinstance(nbytes, (int, float))
                    and 0 <= nbytes < float("inf")):
                raw = rec.get("b64") or rec.get("image") or ""
                nbytes = len(raw) \
                    if isinstance(raw, (str, bytes, bytearray)) else 0
            self._m_wire_bytes.labels(
                format=_wire_fmt_label(rec)).inc(nbytes)
            # ingress bytes charged to the tenant the gateway stamped
            # (records without one -> "unknown"), once per read batch
            ten = rec.get("tenant")
            ten = ten if isinstance(ten, str) else None
            bytes_by_tenant[ten] = bytes_by_tenant.get(ten, 0) + nbytes
            self._span("read", t0, t_read, trace_id=rec["trace_id"],
                       uri=rid)
        for ten, nb in bytes_by_tenant.items():
            self.meter.wire_bytes(ten, nb)
        # priority-ordered claim and shed (armoured deployments only):
        # interactive records stage first; under pressure the lowest
        # classes are shed before they spend a predict slot, and a record
        # that can no longer make its deadline through the backlog is
        # dropped at claim
        if self._armor:
            rank = {prio: i for i, prio in enumerate(PRIORITIES)}
            batch = sorted(batch, key=lambda kv: rank[normalize_priority(
                kv[1].get("priority") if isinstance(kv[1], dict)
                else None)])
            to_shed = shed_classes(self._pressure_level())
        else:
            to_shed = ()
        kept = [(rid, rec) for rid, rec in batch
                if not self._shed_expired(rid, rec)
                and not (self._armor and self._claim_shed(rid, rec,
                                                          to_shed))]

        def pre_one(rec):
            p0 = time.monotonic()
            out = self.preprocess(rec)
            return out, p0, time.monotonic()

        pool = self._preprocess_pool()
        gathered = [(rid, rec, pool.submit(pre_one, rec) if pool else None)
                    for rid, rec in kept]
        items: List = []      # (rid, item, deadline_ns, trace_id, meta)
        for rid, rec, fut in gathered:
            try:
                item, p0, p1 = fut.result() if fut is not None \
                    else pre_one(rec)
                self._pre_fmt_hist.labels(
                    format=_wire_fmt_label(rec)).record(p1 - p0)
                self._span("preprocess", p0, p1,
                           trace_id=rec.get("trace_id"), uri=rid)
                # per-record generation options ride the record untyped —
                # the scheduler validates and clamps the values
                meta = rec.get("gen")
                meta = dict(meta) if isinstance(meta, dict) else {}
                # the identity outlives the record dict: result documents,
                # device-second shares and token charges read it off the
                # meta (None for records without one; the meter folds it)
                ten = rec.get("tenant")
                meta["_tenant"] = normalize_tenant(ten) \
                    if isinstance(ten, str) and ten else None
                if self._armor:
                    # the brownout clamp at submission needs the class
                    meta["_priority"] = normalize_priority(
                        rec.get("priority"))
                if isinstance(rec.get("_resume"), dict):
                    # resume state stapled on at reclaim must reach
                    # _submit_group, like the identity
                    meta["_resume"] = rec["_resume"]
                items.append((rid, item, rec.get("deadline_ns"),
                              rec.get("trace_id"), meta))
            except Exception as e:  # noqa: BLE001 — malformed record
                self._quarantine(rid, "preprocess", e, record=rec)
        if kept:
            self._stages["preprocess"].record(time.monotonic() - t_read)
        groups: Dict[tuple, List] = {}
        for entry in items:
            item = entry[1]
            shape = np.shape(item.data if isinstance(item, QuantizedTensor)
                             else item)
            groups.setdefault(shape, []).append(entry)
        return [self._stack_group([e[0] for e in g], [e[1] for e in g],
                                  [e[2] for e in g], [e[3] for e in g],
                                  t_read, [e[4] for e in g])
                for g in groups.values()]

    def _maybe_trim(self):
        """Amortized memory guard: trim the stream at most once per
        ``trim_interval_s``."""
        interval = self.params.trim_interval_s
        if interval > 0:
            now = time.monotonic()
            if now - self._last_trim < interval:
                return
            self._last_trim = now
        self.queue.trim(self.params.stream_max_len)

    # -- predict plane ----------------------------------------------------------
    def _predict_isolated(self, ids, tensors, scales, tmap=None):
        """Predict with graceful degradation: on failure, bisect the batch
        to isolate the poison input — sane rows still get answers, only the
        culprit is dead-lettered (log2(n) extra predict calls at worst)."""
        try:
            return [(ids, self.model.do_predict(tensors, scales=scales))]
        except Exception as e:  # noqa: BLE001 — device/input failure
            return self._bisect_halves(ids, tensors, scales, e, tmap=tmap)

    def _bisect_halves(self, ids, tensors, scales, exc: BaseException,
                       tmap=None):
        """The bisect step shared by ``_predict_isolated`` and the write
        stage's readback-failure path: a single poisoned row is
        quarantined; a larger batch recurses on its halves."""
        if len(ids) == 1:
            self._quarantine(ids[0], "predict", exc,
                             trace_id=(tmap or {}).get(ids[0]))
            return []
        mid = len(ids) // 2
        lo = self._predict_isolated(
            ids[:mid], tensors[:mid],
            None if scales is None else scales[:mid], tmap=tmap)
        hi = self._predict_isolated(
            ids[mid:], tensors[mid:],
            None if scales is None else scales[mid:], tmap=tmap)
        return lo + hi

    def _dispatch_batch(self, tensors, scales):
        """Enqueue one batch on the device WITHOUT waiting for it
        (``InferenceModel.dispatch``); the write worker calls
        ``.result()``.  A customized ``do_predict`` (instance-patched, or
        overridden by a subclass that keeps the base ``dispatch``) stays on
        the path as a lazy synchronous call, as does a model without
        ``dispatch``."""
        model = self.model
        custom_predict = (
            "do_predict" in vars(model)
            or getattr(type(model), "do_predict", None)
            is not InferenceModel.do_predict)
        custom_dispatch = (
            "dispatch" in vars(model)
            or getattr(type(model), "dispatch", None)
            is not InferenceModel.dispatch)
        if not hasattr(model, "dispatch") or \
                (custom_predict and not custom_dispatch):
            return _LazyResult(
                lambda: model.do_predict(tensors, scales=scales))
        try:
            return model.dispatch(tensors, scales=scales)
        except Exception as e:  # noqa: BLE001 — shape error at dispatch
            return _FailedDispatch(e)

    def _predict_stage(self, ids, tensors, scales=None, deadlines=None,
                       traces=None, t_read=None, t_ready=None,
                       metas=None) -> Optional[_InFlight]:
        """Deadline gate 2 + asynchronous dispatch.  Returns the in-flight
        handle for the write stage, or None when every record was shed."""
        # per-row tenant identity hoisted at preprocess rides the metas;
        # it must survive the gate-2 filter aligned with ids
        tenants = [m.get("_tenant") if isinstance(m, dict) else None
                   for m in (metas or [None] * len(ids))]
        # a record can expire while staged behind a slow predict: shed it
        # here so the batch spends no device time on it
        if deadlines is not None and any(d is not None for d in deadlines):
            keep = [i for i, (rid, dl) in enumerate(zip(ids, deadlines))
                    if not self._shed_expired(
                        rid, None, deadline_ns=dl, stage="stage_wait",
                        trace_id=traces[i] if traces else None,
                        tenant=tenants[i])]
            if not keep:
                return None
            if len(keep) < len(ids):
                ids = [ids[i] for i in keep]
                tensors = tensors[keep]
                if scales is not None:
                    scales = scales[keep]
                if traces is not None:
                    traces = [traces[i] for i in keep]
                tenants = [tenants[i] for i in keep]
        t0 = time.monotonic()
        if t_ready is not None:
            self._stages["stage_wait"].record(t0 - t_ready)
            for rid, tid in zip(ids, traces or [None] * len(ids)):
                self._span("stage_wait", t_ready, t0, trace_id=tid, uri=rid)
        handle = self._dispatch_batch(tensors, scales)
        return _InFlight(ids, tensors, scales, handle, traces, t_read, t0,
                         tenants)

    def _write_stage(self, inflight: _InFlight) -> int:
        """Block on the dispatched batch's host readback, postprocess per
        record, and flush the micro-batch's results in one batched write.
        A readback failure goes straight to the bisect halves (the full
        batch was already tried once)."""
        ids, tensors, scales = inflight.ids, inflight.tensors, inflight.scales
        tmap = dict(zip(ids, inflight.traces or []))
        tenmap = dict(zip(ids, inflight.tenants or []))
        try:
            chunks = [(ids, inflight.handle.result())]
        except Exception as e:  # noqa: BLE001 — device/input failure
            chunks = self._bisect_halves(ids, tensors, scales, e, tmap=tmap)
        # the host readback of .result() waits for the device, so the wall
        # from dispatch ends after the batch's device work
        t_done = time.monotonic()
        predict_wall = t_done - inflight.t_dispatch
        self._stages["predict"].record(predict_wall)
        self._note_predict_time(predict_wall)
        # device seconds: the batch's wall apportioned by row count over
        # the rows dispatched (a quarantined row still used the device,
        # so its tenant is charged: Σ over tenants == the wall)
        rows_by_tenant: Dict[Optional[str], int] = {}
        for rid in ids:
            ten = tenmap.get(rid)
            rows_by_tenant[ten] = rows_by_tenant.get(ten, 0) + 1
        self.meter.device_seconds(rows_by_tenant, predict_wall)
        pairs: List[Tuple[str, Dict]] = []
        for chunk_ids, probs in chunks:
            for rid, row in zip(chunk_ids, probs):
                ten = tenmap.get(rid)
                self._span("predict", inflight.t_dispatch, t_done,
                           trace_id=tmap.get(rid), uri=rid,
                           attrs=({"tenant": ten} if ten else None))
                try:
                    value = {"value": self.postprocess(np.asarray(row))}
                    if ten is not None:
                        value["tenant"] = ten
                    if self.model_version is not None:
                        value["model_version"] = self.model_version
                    if tmap.get(rid) is not None:
                        value["trace_id"] = tmap[rid]
                    deliveries = self._redelivered.pop(rid, None)
                    if deliveries:
                        value["deliveries"] = deliveries
                    pairs.append((rid, value))
                except Exception as e:  # noqa: BLE001 — per-record isolation
                    self._quarantine(rid, "postprocess", e,
                                     trace_id=tmap.get(rid), tenant=ten)
        n = self._flush_results(pairs, tmap=tmap, tenmap=tenmap)
        now = time.monotonic()
        if pairs:
            self._stages["write"].record(now - t_done)
            for rid, _ in pairs:
                self._span("write", t_done, now, trace_id=tmap.get(rid),
                           uri=rid)
        if n and inflight.t_read is not None:
            self._e2e.record(now - inflight.t_read, n=n)
            t_read = inflight.t_read
            e2e_by_tenant: Dict[Optional[str], List[float]] = {}
            for rid, _ in pairs:
                ten = tenmap.get(rid)
                e2e = self._slo_observe(rid, now - t_read, {
                    "pipeline": max(inflight.t_dispatch - t_read, 0.0),
                    "predict": max(t_done - inflight.t_dispatch, 0.0),
                    "write": max(now - t_done, 0.0)}, tenant=ten)
                e2e_by_tenant.setdefault(ten, []).append(e2e)
            for ten, vals in e2e_by_tenant.items():
                self.meter.request_seconds_many(ten, vals)
        if n and self._cold_start_s is None:
            self._cold_start_s = now - self._t_construct
            self._g_cold.set(self._cold_start_s)
        self.total_records += n
        self._maybe_trim()
        return n

    def _predict_and_write(self, ids, tensors, scales=None, deadlines=None,
                           traces=None, t_read=None, t_ready=None,
                           metas=None) -> int:
        """Synchronous predict + write of one staged group (``serve_once``);
        the pipelined loop runs the same two stages on two workers."""
        inflight = self._predict_stage(ids, tensors, scales=scales,
                                       deadlines=deadlines, traces=traces,
                                       t_read=t_read, t_ready=t_ready,
                                       metas=metas)
        if inflight is None:
            return 0
        return self._write_stage(inflight)

    def _predict_loop(self):
        """The serving-predict worker: staged groups -> dispatched handles
        on the bounded write queue (backpressure when it is full)."""
        sup = self._predict_sup
        while not self._stop.is_set():
            if sup is not None:
                sup.heartbeat()
            try:
                group = self._staged.get(timeout=0.1)
            except _EMPTY:
                # drain exit: only once the pre worker is dead AND the
                # buffer is still empty
                if self._draining.is_set() and self._pre_sup is not None \
                        and not self._pre_sup.is_alive() \
                        and self._staged.empty():
                    return
                continue
            inflight = self._predict_stage(*group)
            if inflight is None:
                continue               # the whole group was shed at gate 2
            while not self._stop.is_set():
                try:
                    self._writeq.put(inflight, timeout=0.1)
                    break
                except _FULL:
                    continue           # device pipeline full: backpressure

    def _write_loop(self):
        """The serving-write worker: readback, postprocess, result writes."""
        sup = self._write_sup
        while not self._stop.is_set():
            if sup is not None:
                sup.heartbeat()
            try:
                inflight = self._writeq.get(timeout=0.1)
            except _EMPTY:
                if self._draining.is_set() and self._predict_sup is not None \
                        and not self._predict_sup.is_alive() \
                        and self._writeq.empty():
                    return
                continue
            self._write_stage(inflight)

    # -- generation -----------------------------------------------------------
    def _submit_group(self, group: _Staged) -> None:
        """Unpack one staged micro-batch into per-record requests and feed
        the scheduler.  The waiting room is bounded: when full, the
        generate loop keeps stepping (finishing requests frees it)."""
        tensors = group.tensors
        if group.scales is not None:
            # int8-wire prompts: dequantize on host
            tensors = tensors.astype(np.float32) \
                * np.asarray(group.scales)[:, None]
        n = len(group.ids)
        metas = group.metas or [None] * n
        traces = group.traces or [None] * n
        deadlines = group.deadlines or [None] * n
        for i, rid in enumerate(group.ids):
            meta = metas[i] if isinstance(metas[i], dict) else {}
            mt = meta.get("max_tokens")
            try:
                mt = None if mt is None else int(mt)
            except (TypeError, ValueError):
                mt = None
            if self._brownout is not None:
                # brownout stage 2: clamp the generation budget of
                # non-interactive traffic, lower-only.  A host-side budget
                # at admission: the request ends at a quantum's boundary
                # like any budget, and no lane changes shape
                clamp = self._brownout.clamp_max_tokens(
                    meta.get("_priority", "batch"))
                if clamp is not None:
                    mt = clamp if mt is None else min(mt, clamp)
            resume = meta.get("_resume")
            rtoks, epoch = None, 0
            if isinstance(resume, dict):
                rtoks = resume.get("tokens") or None
                try:
                    epoch = int(resume.get("epoch") or 0)
                except (TypeError, ValueError):
                    epoch = 0
            req = GenRequest(rid, np.asarray(tensors[i]),
                             deadline_ns=deadlines[i], trace_id=traces[i],
                             t_read=group.t_read, max_tokens=mt,
                             tenant=meta.get("_tenant"),
                             resume_tokens=rtoks, epoch=epoch)
            if self.snapshot_path is not None \
                    and self._gen_params.checkpoint_interval > 0:
                # ownership and resume state travel together: the lease
                # annotation points the NEXT owner at this replica's spool
                # under this epoch
                try:
                    self.queue.annotate(rid, {"spool": self.snapshot_path,
                                              "epoch": epoch,
                                              "replica": self.replica_id})
                except Exception:  # noqa: BLE001 — best-effort: a lost
                    pass           # annotation degrades to a restart
            while not self._batcher.submit(req):
                if self._stop.is_set():
                    return
                # a full boundary, not a bare step: tokens emitted while
                # the waiting room blocks are still charged to tenants
                self._gen_tick()

    def _gen_tick(self) -> None:
        """One decode-step boundary + its bookkeeping (stage timer, step and
        token counters, tokens/s window, per-boundary decode spans)."""
        b = self._batcher
        t0 = time.monotonic()
        events = b.step()
        now = time.monotonic()
        if b.active or events:
            self._stages["predict"].record(now - t0)
        rows_by_tenant: Dict[Optional[str], int] = {}
        for rid, tid, emitted, ten in b.last_boundary:
            attrs = {"tokens": emitted}
            if ten is not None:
                attrs["tenant"] = ten
            self._span("decode", t0, now, trace_id=tid, uri=rid,
                       attrs=attrs)
            # tokens are charged per tenant at each boundary, not at
            # finish: a long generation bills as it burns, and a
            # mid-flight shed stays charged
            self.meter.tokens(ten, emitted)
            rows_by_tenant[ten] = rows_by_tenant.get(ten, 0) + 1
        # the boundary's wall (it ends with the host readback of the
        # quanta's tokens, after their device work) apportioned by slot
        # occupancy: the generation plane's device seconds
        self.meter.device_seconds(rows_by_tenant, now - t0)
        if b.decode_steps > self._last_steps:
            self._m_decode_steps.inc(b.decode_steps - self._last_steps)
            self._last_steps = b.decode_steps
        self._update_tps(now)
        # spool this boundary's checkpoints BEFORE the crash fault below,
        # so an injected mid-decode kill dies with its resume state
        # already durable — the ordering a real preemption depends on
        self._maybe_checkpoint()
        if b.resumed > self._last_resumed:
            self._m_resumed.inc(b.resumed - self._last_resumed)
            self._last_resumed = b.resumed
        if self._faults.decode_crash_active \
                and self._faults.take_decode_crash(b.generated_tokens):
            logger.error(
                "faults: injected decode_crash_after_n_tokens (%d "
                "generated) — exiting", b.generated_tokens)
            os._exit(3)
        kinds = [ev.kind for ev in events]
        if any(k in ("finish", "shed", "quarantine") for k in kinds) or \
                b.last_admitted:
            self._event("gen_boundary", active=b.active, waiting=b.waiting,
                        admitted=b.last_admitted,
                        finished=kinds.count("finish"),
                        shed=kinds.count("shed"),
                        quarantined=kinds.count("quarantine"))
        self._handle_gen_events(events)

    def _maybe_checkpoint(self) -> None:
        """Drain the scheduler's queued snapshots into the replica's
        snapshot spool, stamping each with its integrity checksum (which
        the armed ``snapshot_corrupt`` fault breaks on purpose).  Runs on
        the generate worker, as in the JAX package: JSON and one append a
        boundary.  Without a ``snapshot_path`` the drained batch is
        discarded: checkpointing is durable or off, never buffered."""
        b = self._batcher
        if not b.pending_checkpoints:
            return
        snaps = b.drain_checkpoints()
        if self.snapshot_path is None:
            return
        corrupt = self._faults.snapshot_corrupt_active
        for rec in snaps:
            crc = tracecollect.snapshot_checksum(rec)
            if corrupt:
                crc ^= 0x5A5A5A5A
            rec["crc"] = crc
        try:
            tracecollect.append_snapshots(self.snapshot_path, snaps,
                                          source=self.replica_id)
            size = 0
            for path in (self.snapshot_path, self.snapshot_path + ".1"):
                try:
                    size += os.path.getsize(path)
                except OSError:
                    pass
            b.snapshot_bytes = size
            self._event("gen_checkpoint", count=len(snaps),
                        tokens=sum(int(r.get("n") or 0) for r in snaps),
                        spool_bytes=size)
        except Exception as e:  # noqa: BLE001 — a full or read-only disk
            # must not take decode down; a resume degrades to older
            # snapshots or a restart, both loud on the other side
            logger.warning("serving: checkpoint spool write failed "
                           "(%s: %s)", type(e).__name__, e)

    def _update_tps(self, now: float) -> None:
        """Roll the tokens/s window; idle iterations call it too, so the
        gauge decays to 0 when traffic stops."""
        wt0, wtok = self._tps_window
        if now - wt0 >= 1.0:
            tok = self._batcher.generated_tokens
            self._g_tps.set((tok - wtok) / max(now - wt0, 1e-9))
            self._tps_window = (now, tok)

    def _handle_gen_events(self, events) -> None:
        """Scheduler events -> record contracts: finish -> batched result
        write + ack, partial -> best-effort streaming overwrite, shed ->
        terminal deadline marker, quarantine -> dead-letter, first_token ->
        TTFT."""
        pairs: List[Tuple[str, Dict]] = []
        finals = []
        for ev in events:
            if ev.kind == "first_token":
                if ev.ttft_s is not None:
                    self._m_ttft.record(ev.ttft_s)
                    now0 = time.monotonic()
                    self._span("prefill", now0 - ev.ttft_s, now0,
                               trace_id=ev.trace_id, uri=ev.rid)
            elif ev.kind == "partial":
                if self._brownout is not None \
                        and self._brownout.suppress_partials:
                    # brownout stage 1: partials are progress cosmetics;
                    # under SLO burn the write bandwidth goes to finals
                    continue
                value = {"partial": True, "tokens": ev.tokens,
                         "n": len(ev.tokens)}
                if ev.trace_id is not None:
                    value["trace_id"] = ev.trace_id
                try:
                    # best-effort: the next interval (or the terminal
                    # write) overwrites; put_partial never shadows a
                    # terminal result
                    self.queue.put_partial(ev.rid, value)
                except Exception:  # noqa: BLE001
                    pass
            elif ev.kind == "finish":
                value = {"value": {"tokens": ev.tokens,
                                   "length": len(ev.tokens),
                                   "finish_reason": ev.finish_reason}}
                if ev.trace_id is not None:
                    value["trace_id"] = ev.trace_id
                if ev.tenant is not None:
                    value["tenant"] = ev.tenant
                if self.model_version is not None:
                    value["model_version"] = self.model_version
                deliveries = self._redelivered.pop(ev.rid, None)
                if deliveries:
                    value["deliveries"] = deliveries
                pairs.append((ev.rid, value))
                finals.append(ev)
            elif ev.kind == "shed":
                if ev.tokens is not None:
                    err = ("deadline-exceeded: budget elapsed "
                           f"mid-generation after {len(ev.tokens)} "
                           "token(s)")
                    extra = {"tokens": ev.tokens, "n": len(ev.tokens)}
                else:
                    err = "deadline-exceeded: budget elapsed before decode"
                    extra = None
                self._shed_terminal(ev.rid, stage="generate",
                                    trace_id=ev.trace_id, error=err,
                                    extra=extra, tenant=ev.tenant)
            elif ev.kind == "quarantine":
                self._quarantine(ev.rid, "generate",
                                 RuntimeError(ev.error
                                              or "generation failed"),
                                 trace_id=ev.trace_id, tenant=ev.tenant)
            elif ev.kind == "resume_failed":
                # the batcher could not replay the resume prefix (malformed,
                # out of vocab, capacity): the request restarts from 0 and
                # its prefix is recomputed work
                wasted = len(ev.tokens or ())
                if wasted:
                    self._m_resume_wasted.inc(wasted)
                self._event("gen_resume_failed", rid=ev.rid,
                            trace_id=ev.trace_id, reason=ev.error,
                            wasted=wasted)
        if not pairs:
            return
        t_w = time.monotonic()
        n = self._flush_results(pairs,
                                tmap={ev.rid: ev.trace_id for ev in finals},
                                tenmap={ev.rid: ev.tenant for ev in finals})
        now = time.monotonic()
        self._stages["write"].record(now - t_w)
        for ev in finals:
            self._span("write", t_w, now, trace_id=ev.trace_id, uri=ev.rid)
            if ev.t_read is not None:
                self._e2e.record(now - ev.t_read)
                stages = {}
                if ev.wall_s is not None:
                    stages["decode"] = max(float(ev.wall_s), 0.0)
                e2e = self._slo_observe(ev.rid, now - ev.t_read, stages,
                                        tenant=ev.tenant)
                self.meter.request_seconds(ev.tenant, e2e)
        if n and self._cold_start_s is None:
            self._cold_start_s = now - self._t_construct
            self._g_cold.set(self._cold_start_s)
        self.total_records += n
        self._maybe_trim()

    def serve_once(self) -> int:
        """Synchronous drive (tests and embedded callers): read one
        micro-batch and serve it — predict and write each group, or step
        the scheduler until every admitted request reached a terminal
        state.  Returns results written."""
        staged = self._read_and_preprocess()
        if self._batcher is None:
            return sum(self._predict_and_write(*group)
                       for group in staged or ())
        with torch.inference_mode():
            for group in staged or ():
                self._submit_group(group)
            before = self.total_records
            while not self._batcher.idle and not self._stop.is_set():
                self._gen_tick()
        return self.total_records - before

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Supervised workers.  ``serving-preprocess`` reads and decodes
        coalesced micro-batches into a bounded staging queue.  Then, on the
        predict plane, ``serving-predict`` gates deadlines and dispatches
        batches to the device without waiting (up to ``inflight_batches``
        queued) and ``serving-write`` reads each back, postprocesses and
        writes the results, so host preprocess, device compute and result
        writes overlap.  In generation mode one ``serving-generate`` worker
        owns both decode stepping and result writing — results must flush
        AT step boundaries."""
        p = self.params
        self._stop.clear()
        self._draining.clear()
        self._retiring.clear()
        self._t_start = time.monotonic()
        try:
            self.queue.open_admission()
        except Exception:  # noqa: BLE001 — backend down: workers report
            pass
        # bind the probe server first: a port conflict must fail start()
        # before any worker begins consuming the queue
        if p.http_port is not None and self._http is None:
            from analytics_zoo_tpu_torch.serving.http import HealthServer
            self._http = HealthServer(self, host=p.http_host,
                                      port=p.http_port).start()
        self._staged = Queue(maxsize=p.pipeline_depth)
        self._last_trim = time.monotonic()
        self._pre_sup = SupervisedThread(
            self._pre_loop, name="serving-preprocess",
            max_restarts=p.max_worker_restarts,
            backoff_s=p.worker_backoff_s, stop_event=self._stop)
        loops = {"serving-generate": self._generate_loop} \
            if self._batcher is not None else \
            {"serving-predict": self._predict_loop,
             "serving-write": self._write_loop}
        sups = {name: SupervisedThread(
            fn, name=name, max_restarts=p.max_worker_restarts,
            backoff_s=p.worker_backoff_s, stop_event=self._stop)
            for name, fn in loops.items()}
        self._gen_sup = sups.get("serving-generate")
        self._predict_sup = sups.get("serving-predict")
        self._write_sup = sups.get("serving-write")
        if self._batcher is None:
            # dispatch() takes no semaphore, so the handle queue is what
            # bounds device-resident batches: clamp it to the model's
            # supported_concurrent_num
            inflight = max(1, p.inflight_batches)
            cap = getattr(self.model, "concurrent_num", None)
            if cap is not None and inflight > cap:
                logger.warning(
                    "serving: inflight_batches=%d exceeds the model's "
                    "supported_concurrent_num=%d; clamping the handle "
                    "queue", inflight, cap)
                inflight = max(1, cap)
            self._writeq = Queue(maxsize=inflight)
        if p.warmup and isinstance(self.model, InferenceModel):
            self._start_warmup()
        for sup in self._sups:
            sup.start()
        self._event("start", mode=("generation" if self._batcher is not None
                                   else "predict"),
                    max_batch=p.max_batch or p.batch_size,
                    quantized_bits=self._quantized_bits() or None)
        return self

    # -- ahead-of-time warm-up -------------------------------------------------
    def _start_warmup(self) -> None:
        """Derive the warm-up manifest and warm it on a daemon thread.  An
        underivable manifest (no declared input shape and no spec) is a
        warning, not a failed start: the deployment serves eagerly."""
        try:
            if self._batcher is not None:
                manifest = self._batcher.warmup_manifest()
            else:
                manifest = aot.resolve_manifest(self.model,
                                                self.params.warmup)
        except Exception as e:  # noqa: BLE001 — stay on the eager path
            logger.warning(
                "serving: warm-up disabled — manifest underivable (%s: "
                "%s); pass warmup={'shape': [...]} in params",
                type(e).__name__, e)
            self._warm_state.update(state="off", error=str(e))
            return
        # `pending` BEFORE the thread runs: a readiness probe between
        # start() and the first entry must already say warming
        self._warm_state.update(state="pending", total=len(manifest),
                                compiled=0, failed=0, seconds=None)
        self._event("warmup", state="pending", total=len(manifest))
        self._warm_thread = threading.Thread(
            target=self._warmup_loop, args=(manifest,),
            name="serving-warmup", daemon=True)
        self._warm_thread.start()

    def _warmup_loop(self, manifest) -> None:
        self._warm_state["state"] = "warming"
        self._event("warmup", state="warming",
                    total=self._warm_state.get("total"))
        # an armed warmup_crash kills the PROCESS here: a real crash
        # mid-warm-up, not the exception handler below
        self._faults.check_warmup()

        def progress(done, total, entry):
            self._warm_state["compiled"] = done

        try:
            if self._batcher is not None:
                stats = self._batcher.warm(manifest, progress=progress,
                                           stop=self._stop.is_set)
            else:
                stats = aot.warm_up(self.model, manifest, progress=progress,
                                    stop=self._stop.is_set)
        except Exception as e:  # noqa: BLE001 — a warm-up crash must not
            # hold readiness forever; the eager path still serves
            logger.exception("serving: warm-up pass failed")
            self._warm_state.update(state="failed", error=str(e))
            self._event("warmup", state="failed", error=str(e)[:200])
            return
        if stats.get("stopped"):
            self._warm_state.update(state="cancelled")
            return
        state = "ready" if not stats["failed"] else "degraded"
        self._warm_state.update(
            state=state, failed=stats["failed"], seconds=stats["seconds"],
            compile_stats=stats["compile_stats"])
        self._event("warmup", state=state, programs=stats["programs"],
                    failed=stats["failed"], seconds=stats["seconds"])
        self._g_warm.labels(phase="compile").set(float(stats["seconds"]))
        if self._cold_start_s is None:
            # serving-capable without having seen traffic yet: the clock
            # stops at warm-up completion, not at the first record
            self._cold_start_s = time.monotonic() - self._t_construct
            self._g_cold.set(self._cold_start_s)
        logger.info(
            "serving: replica %s warm — %d/%d program(s) in %.2fs (%s "
            "graph capture(s))", self.replica_id,
            stats["programs"] - stats["failed"], stats["programs"],
            stats["seconds"], stats["compile_stats"]["captures"])

    def warmup_state(self) -> Dict:
        """Warm-up progress document (health and readiness)."""
        return dict(self._warm_state)

    def _pre_loop(self):
        sup = self._pre_sup
        while not self._stop.is_set():
            if sup is not None:
                sup.heartbeat()
            staged = self._read_and_preprocess()
            if not staged:
                # None = stream empty; only that may end a drain, and only
                # when the backend is reachable (an outage also reads as
                # empty, but its backlog is still out there)
                if staged is None and self._draining.is_set():
                    try:
                        if self.queue.read_path_healthy():
                            return
                    except Exception:  # noqa: BLE001 — state unknown
                        pass
                time.sleep(0.005)
                continue
            for group in staged:
                while not self._stop.is_set():
                    try:
                        self._staged.put(group, timeout=0.1)
                        break
                    except _FULL:
                        # backpressure; still alive
                        self._hb_ts = time.monotonic()

    def _generate_loop(self):
        """The serving-generate worker.  ``torch.inference_mode`` is
        thread-local, so it is entered here, in the worker thread."""
        with torch.inference_mode():
            self._generate_steps()

    def _generate_steps(self):
        sup = self._gen_sup
        b = self._batcher
        while not self._stop.is_set():
            if sup is not None:
                sup.heartbeat()
            # idle scheduler: block briefly for new work; busy: only sweep
            # what is already staged, then take the next decode step
            try:
                group = self._staged.get(timeout=0.1) if b.idle \
                    else self._staged.get_nowait()
            except _EMPTY:
                group = None
            while group is not None:
                self._submit_group(group)
                try:
                    group = self._staged.get_nowait()
                except _EMPTY:
                    group = None
            if b.idle:
                self._update_tps(time.monotonic())
                if self._draining.is_set() and self._pre_sup is not None \
                        and not self._pre_sup.is_alive() \
                        and self._staged.empty():
                    return             # drain: upstream done + slots empty
                continue
            self._gen_tick()

    # -- health + metrics -----------------------------------------------------
    def stage_metrics(self) -> Dict:
        doc = {name: st.snapshot() for name, st in self._stages.items()}
        doc["e2e"] = self._e2e.snapshot()
        return doc

    def _quantized_bits(self) -> int:
        """0 float, 8 W8A8, 4 W4A16 — what the loaded model serves with."""
        return quantized_bits(getattr(self.model, "_params", None) or {})

    def _resources_doc(self) -> Dict:
        """The health document's ``resources`` block (never raises: a
        probe must answer even when a component read fails)."""
        try:
            return self._ledger.doc()
        except Exception as e:  # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}"}

    @staticmethod
    def _process_doc() -> Dict:
        try:
            return process_stats()
        except Exception:  # noqa: BLE001
            return {}

    def drain_usage(self) -> List[Dict]:
        """Per-interval usage deltas since the last drain, one record per
        (tenant, model) with activity (``tracecollect.append_usage``
        journals them)."""
        return self.meter.drain()

    def health(self) -> Dict:
        """Serving health document: worker states, breaker state, record /
        dead-letter / shed counters, per-stage timing, queue health, the
        quantized width, the generation block (generation mode) and the
        readiness verdict."""
        workers = {sup.name: sup.health() for sup in self._sups}
        running = bool(workers) and all(
            w["state"] in (SupervisedThread.STARTING,
                           SupervisedThread.RUNNING,
                           SupervisedThread.RESTARTING)
            for w in workers.values())
        try:
            queue_health = self.queue.health()
        except Exception as e:  # noqa: BLE001 — backend down != probe down
            queue_health = {"backend": type(self.queue).__name__,
                            "reachable": False,
                            "error": f"{type(e).__name__}: {e}"}
        try:
            device = str(self.model.device)
        except AttributeError:
            device = None
        h = {"running": running,
             "draining": self._draining.is_set(),
             "uptime_s": round(time.monotonic() - self._t_start, 3),
             "pid": os.getpid(),
             "snapshot_seq": next(self._snapshot_seq),
             "clock": {"wall": time.time(), "monotonic": time.monotonic()},
             "replica_id": self.replica_id,
             "model_version": self.model_version,
             "device": device,
             "heartbeat_age_s": round(self._heartbeat_age(), 3),
             "reclaimed": self.reclaimed,
             "duplicates": self.duplicates,
             "total_records": self.total_records,
             "dead_lettered": self.dead_lettered,
             "shed": self.shed,
             "warmup": self.warmup_state(),
             "cold_start_s": (None if self._cold_start_s is None
                              else round(self._cold_start_s, 3)),
             "quantized_bits": self._quantized_bits(),
             # device memory by component and the process's resources
             "resources": self._resources_doc(),
             "process": self._process_doc(),
             "recorder": self.recorder.stats(),
             "breaker": self._breaker.health(),
             "dead_letter_breaker": self._dead_breaker.health(),
             # the live data-plane knob targets
             "knobs": self.knobs(),
             "workers": workers,
             "stages": self.stage_metrics(),
             "queue": queue_health}
        if self._batcher is not None:
            h["kv_state"] = self._batcher.state_bytes_doc()
            h["generation"] = self._batcher.stats()
        if self._slo is not None:
            h["slo"] = self._slo.snapshot()
        # cumulative per-tenant usage totals
        h["usage"] = self.meter.snapshot()
        if self._admission is not None:
            h["admission"] = self._admission.snapshot()
        if self._brownout is not None:
            h["brownout"] = self._brownout.snapshot()
        if self._faults.any_active:
            # an armed replica is visible from the outside
            h["faults"] = self._faults.describe()
        h["ready"] = self._readiness(h)
        return h

    def _readiness(self, h: Dict) -> Dict:
        reasons = []
        if h["draining"]:
            reasons.append("draining")
        if not h["running"]:
            reasons.append("workers-not-running")
        w = h.get("warmup") or {}
        if w.get("state") in ("pending", "warming"):
            # a replica still warming serves eagerly meanwhile; `failed` and
            # `degraded` do not hold readiness
            reasons.append(
                f"warming ({w.get('compiled', 0)}/{w.get('total', 0)} "
                f"programs)")
        if h["breaker"]["state"] == CircuitBreaker.OPEN:
            reasons.append("result-write-breaker-open")
        q = h["queue"]
        if not q.get("reachable", True):
            reasons.append("backend-unreachable")
        rb = q.get("read_breaker")
        if rb is not None and rb["state"] == CircuitBreaker.OPEN:
            reasons.append("read-breaker-open")
        cap = self.params.ready_queue_depth
        if cap is None:
            cap = q.get("max_depth")
        depth = q.get("depth", -1)
        if cap is not None and depth >= 0 and depth >= cap:
            reasons.append(f"queue-depth {depth} >= {cap}")
        if self._faults.readyz_active:
            # hold readiness for the configured uptime
            fr = self._faults.readyz_block_reason(h["uptime_s"])
            if fr:
                reasons.append(fr)
        return {"ready": not reasons, "reasons": reasons}

    def ready(self) -> Dict:
        """Readiness document; while a warm-up runs it carries its
        progress block."""
        doc = dict(self.health()["ready"])
        if self._warm_state.get("state") != "off":
            doc["warmup"] = {k: self._warm_state.get(k)
                             for k in ("state", "compiled", "total",
                                       "seconds")}
        return doc

    @staticmethod
    def metrics_from_health(h: Dict) -> Dict:
        e2e = h["stages"]["e2e"]
        doc = {"served": h["total_records"],
               "quarantined": h["dead_lettered"],
               "shed": h["shed"],
               "restarts": sum(w["restart_count"]
                               for w in h["workers"].values()),
               "queue_depth": h["queue"].get("depth", -1),
               "dead_letters": h["queue"].get("dead_letters", -1),
               "breaker_trips": h["breaker"]["trip_count"],
               "stages": h["stages"],
               "latency_ms": {"p50": e2e["p50_ms"], "p99": e2e["p99_ms"]}}
        if isinstance(h.get("admission"), dict):
            doc["admitted"] = h["admission"].get("admitted", 0)
            doc["rejected"] = h["admission"].get("rejected", 0)
        if isinstance(h.get("brownout"), dict):
            doc["brownout_stage"] = h["brownout"].get("stage", 0)
        return doc

    def metrics(self) -> Dict:
        return self.metrics_from_health(self.health())

    def prom_metrics(self) -> str:
        return self.registry.to_prometheus()

    def export_trace(self, path: str) -> str:
        return self.tracer.export_chrome_trace(path)

    def shutdown(self, drain_s: Optional[float] = None,
                 close_admission: bool = True):
        """Stop serving.  With ``drain_s``: close admission on the queue
        (or, with ``close_admission=False``, only stop claiming — the
        scale-down drain), let the workers finish the backlog and every
        in-flight generation, then join — hard-stopping when the budget
        runs out.  Without it: immediate stop."""
        drain_s = drain_s or 0.0
        self._event("shutdown", drain_s=drain_s, retire=not close_admission)
        sups = self._sups
        if drain_s > 0 and sups:
            self._draining.set()
            if close_admission:
                try:
                    self.queue.close_admission()
                except Exception:  # noqa: BLE001 — backend down: drain
                    pass
            else:
                self._retiring.set()
            wait_until(lambda: not any(s.is_alive() for s in sups), drain_s)
        self._stop.set()
        for sup in sups:
            sup.join(timeout=5)
        if self._warm_thread is not None:
            # the pass checks the stop flag between entries
            self._warm_thread.join(timeout=30)
        if self._pre_pool is not None:
            self._pre_pool.shutdown(wait=False)
            self._pre_pool = None
        if self._http is not None:
            self._http.stop()
            self._http = None
        for gauge, fn in self._gauge_fns:
            gauge.remove_function(fn)
        self._gauge_fns = []
        self._hb_gauge.remove(replica=self.replica_id)
        try:
            _wire.detach_all()
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass
