"""``InferenceModel`` — the serving plane's model holder, ported from the
JAX package's ``inference/inference_model.py``.

- ``supported_concurrent_num`` is the concurrency contract: it bounds how
  many ``do_predict`` callers run at once (a semaphore) and how many
  batches one ``do_predict`` keeps in flight on the device before it reads
  results back.  CUDA work is enqueued asynchronously, so padding and
  transferring batch k+1 overlaps batch k's device compute.
- **bucketed batching**: a batch is zero-padded to the next power of two
  (``_bucket``, at most ``max_batch``), so a handful of shapes serve any
  request size; ``result()`` strips the padding.
- ``dispatch`` enqueues one batch and returns a handle whose ``result()``
  copies to the host; the serving engine's write stage calls it.
- ``scales``: per-row dequantization factors for a compact int8/uint8
  batch — rows travel to the device in their wire dtype and are
  dequantized there.
- ``do_quantize``: post-training int8 / int4 weight quantization
  (``inference/quantize.py``) of Dense layers and convolutions, served
  through the hand-written ``w8a8`` / ``w4a16`` CUDA kernels and, for a
  spatial int8 convolution, ``w8a8_conv2d``.

- ``warm``: ahead-of-time warm-up of one bucket (``inference/aot.py``
  walks the manifest): the bucket's padded forward runs once, so its
  first-call setup is done before traffic.  It is not captured as a CUDA
  graph: on the card a replayed bucket moved records/s by -4% to +7% and
  raised the median latency by 30-53% (``predict_graph_probe.py``,
  PERF.md).

- ``do_load`` / ``do_load_store``: a topology builder and a ``.npz``
  weights file or an mmap'd weight store (``inference/weightstore.py``,
  the JAX package's format: a store written by either package loads in
  the other).

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
Sharding and the framework bridges are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.nn.module import Layer

logger = logging.getLogger(__name__)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def _bucket(n: int, max_batch: int) -> int:
    """Power-of-two bucket for an n-row batch, at most ``max_batch``."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def _pad_to_bucket(xs: List[np.ndarray], scales, n: int, bucket: int):
    """Zero-pad the batch arrays (and per-row scales, padded with ones)
    from ``n`` rows up to ``bucket`` — the one padding shared by
    ``do_predict`` and ``dispatch``."""
    if n < bucket:
        xs = [np.concatenate(
            [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)])
            for a in xs]
    if scales is None:
        return xs, None
    sc = np.concatenate([np.asarray(scales, np.float32),
                         np.ones((bucket - n,), np.float32)])
    return xs, sc


def _to_host(y, take: int):
    if isinstance(y, (list, tuple)):
        return [_to_host(a, take) for a in y]
    return y[:take].detach().cpu().numpy()


class _LazyPending:
    """Deferred-call result handle (``dispatch``'s oversized-batch path):
    the work happens at ``result()``."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def result(self):
        return self._fn()


def _not_ported(what: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"InferenceModel: {what} is not ported "
                                  "yet")
    return method


class InferenceModel:
    """Holds one loaded model on one device."""

    def __init__(self, supported_concurrent_num: int = 2,
                 max_batch: int = 1024, registry=None,
                 device: DeviceLike = None):
        # the bucket ladder is pow-2 by contract: clamp DOWN to the nearest
        # power of two, as the JAX package does
        mb = max(1, int(max_batch))
        self.max_batch = _pow2_floor(mb)
        if self.max_batch != mb:
            logger.warning(
                "InferenceModel: max_batch=%d is not a power of two; "
                "clamping to %d", mb, self.max_batch)
        self.concurrent_num = max(1, int(supported_concurrent_num))
        self.device = resolve_device(device)
        self._model: Optional[torch.nn.Module] = None
        self._params = None
        self._state = None
        self._sem = threading.BoundedSemaphore(self.concurrent_num)
        self.load_seconds: Optional[float] = None   # last do_load* wall
        self.load_mmap = False          # last load used the mmap store
        # predict/dispatch latency + batch-size histograms: bound lazily to
        # the serving engine's registry (or the process one); an explicit
        # registry stays pinned
        self._obs_registry = registry
        self._obs_registry_explicit = registry is not None
        self._obs = None
        # warmed signatures and the calls that found theirs warm (hits);
        # cleared whenever the program changes (re-load, quantize), which
        # bumps the epoch
        self._warmed: Set[tuple] = set()
        # signatures first run outside the warm-up (a bucket past the
        # warmed ladder, e.g. after a retune): each is one cold first call
        self._cold: Set[tuple] = set()
        self._hits = 0
        self._warm_lock = threading.Lock()
        self._epoch = 0
        # manifest-style program label -> executions
        self._execs: Dict[str, int] = {}
        # the CUDA graphs captured over this model (``capture``), held
        # weakly: a graph's pool counts while its owner keeps it
        self._graphs = weakref.WeakSet()

    # -- telemetry -------------------------------------------------------------
    def bind_registry(self, registry) -> bool:
        """Adopt ``registry`` for the predict/dispatch histograms (a
        ClusterServing calls this); a model built with an explicit registry
        stays pinned and returns False."""
        if self._obs_registry_explicit:
            return False
        self._obs_registry = registry
        self._obs = None
        return True

    def _observe(self, method: str, n: int, dt_s: float) -> None:
        if self._obs is None:
            from analytics_zoo_tpu_torch.common.observability import (
                get_registry)
            reg = self._obs_registry or get_registry()
            self._obs_registry = reg
            self._obs = (
                reg.histogram("inference_predict_seconds",
                              "Model predict/dispatch wall latency",
                              labels=("method", "sharding")),
                reg.histogram("inference_batch_size",
                              "Records per predict/dispatch call",
                              labels=("method",),
                              buckets=tuple(float(1 << i)
                                            for i in range(12))))
        self._obs[0].labels(method=method, sharding="off").observe(dt_s)
        self._obs[1].labels(method=method).observe(float(n))

    # -- loaders ----------------------------------------------------------------
    def _refresh_params(self) -> None:
        """The loaded model's params (and state) as JAX-layout trees of
        detached tensors: what ``manager warmup`` exports to the weight
        store, so a store always holds the JAX layout."""
        from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                           export_state)
        model = self._model
        if isinstance(model, Layer):
            self._params = export_params(model)
            self._state = export_state(model)
        else:
            self._params = dict(model.named_parameters())
            self._state = {}

    def do_load_model(self, model: torch.nn.Module, params=None,
                      state=None):
        """Load an in-memory module: moved to this model's device and put
        in eval mode.  ``params`` — a JAX-layout param pytree of numpy
        arrays (``utils/convert.load_jax_params``) — replaces the module's
        own weights when given; ``state`` — a JAX-layout state tree (the
        BatchNormalization moving statistics,
        ``utils/convert.load_jax_state``) — replaces its state buffers."""
        from analytics_zoo_tpu_torch.utils.convert import (load_jax_params,
                                                           load_jax_state)
        t0 = time.perf_counter()
        model = model.to(self.device).eval()
        if params is not None:
            load_jax_params(model, params)
        if state is not None:
            load_jax_state(model, state)
        self._model = model
        self._refresh_params()
        self._reset_warm()
        self.load_seconds = time.perf_counter() - t0
        return self

    def do_load(self, topology_builder: Callable[[], torch.nn.Module],
                weights_path: str):
        """Rebuild the topology with ``topology_builder`` and load its
        weights: a DIRECTORY is an mmap'd weight store
        (:meth:`do_load_store`); a file is a ``.npz`` weights file (either
        package's), read through the model's ``init_weights()`` and
        ``load_weights(path)``."""
        t0 = time.perf_counter()
        if os.path.isdir(weights_path):
            return self.do_load_store(topology_builder, weights_path)
        model = topology_builder()
        model.init_weights()
        model.load_weights(weights_path)
        out = self.do_load_model(model)
        self.load_seconds = time.perf_counter() - t0
        self.load_mmap = False
        return out

    def do_load_store(self, topology_builder: Callable[[], torch.nn.Module],
                      store_dir: str):
        """Restore weights from an mmap'd store directory
        (``inference/weightstore.py``): each leaf is a bare ``.npy`` mapped
        with ``np.load(mmap_mode="r")`` — the boot touches no weight bytes
        until the copy into the model reads them, and every replica on the
        host maps the SAME page-cache pages.  The model moves to this
        model's device first, so each leaf is copied once, from the mapped
        pages into its parameter (no host copy between on the card; on the
        CPU the parameter is a private copy the store never sees written).

        Leaves are matched by key, else by position (the naturally sorted
        order, every leaf's shape and dtype checked); a quantized store
        (int8 / int4 leaves and scales) restores by its own paths, its
        containers remapped onto the model's and shared leaves checked."""
        from analytics_zoo_tpu_torch.inference import weightstore
        from analytics_zoo_tpu_torch.inference.quantize import QUANT_LEAVES
        from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                           export_state,
                                                           load_jax_params,
                                                           load_jax_state)
        t0 = time.perf_counter()
        model = topology_builder().to(self.device)
        like = {"params": export_params(model), "state": export_state(model)}
        try:
            tree = weightstore.load_store(store_dir, like=like)
        except KeyError:
            # a QUANTIZED store does not match the float model's template:
            # restore by the stored paths.  Gated on the store holding
            # quantized leaves — a FLOAT store that failed the keyed and
            # positional match is corrupt or belongs to another topology,
            # and must keep failing loudly here, not at first predict
            manifest = weightstore.read_manifest(store_dir) or {}
            names = {k.rsplit("/", 1)[-1]
                     for k in (manifest.get("leaves") or {})}
            if not names & set(QUANT_LEAVES):
                raise
            tree = weightstore.load_store_nested(store_dir, like=like)
            # paramless/stateless layers' empty {} slots produce no store
            # leaves: graft the template's containers around the restored
            # leaves ({W_q4, s_g} may replace the template's {W})
            tree["params"] = weightstore.graft_containers(
                like["params"], tree.get("params", {}),
                require_leaves=False)
            tree["state"] = weightstore.graft_containers(
                like["state"], tree.get("state", {}))
        load_jax_params(model, tree["params"])
        if tree["state"]:
            load_jax_state(model, tree["state"])
        out = self.do_load_model(model)
        self.load_seconds = time.perf_counter() - t0
        self.load_mmap = True
        return out

    do_load_tensorflow = _not_ported("the TensorFlow bridge (ROADMAP "
                                     "queue 1, item 10)")
    do_load_onnx = _not_ported("the ONNX bridge (ROADMAP queue 1, item 10)")
    do_load_pytorch = _not_ported("the TorchScript bridge (ROADMAP queue 1, "
                                  "item 10)")
    shard = _not_ported("sharded predict (multi-GPU serving, ROADMAP "
                        "queue 1, item 7's second part)")

    # -- quantization -------------------------------------------------------------
    def do_quantize(self, calib_inputs, force: bool = False, bits: int = 8,
                    group_size: int = 64,
                    percentile: Optional[float] = None):
        """Post-training weight quantization of the loaded model.

        ``bits=8`` (W8A8): ``calib_inputs`` — one batch, a list of
        batches, or a ``FeatureSet`` (its first batches) — calibrates the
        per-layer activation scales (``percentile`` clips at that
        percentile of |x| instead of the absmax); Dense and convolution
        weights become int8 with per-output-channel scales.
        ``bits=4`` (W4A16): weight-only int4 with group-wise scales
        (``group_size`` rows per scale); ``calib_inputs`` may be None.

        Opt-in: without ``force=True`` this warns and does nothing, as in
        the JAX package — quantizing trades accuracy for weight bytes, and
        what it buys on this card is in ``PERF.md``."""
        from analytics_zoo_tpu_torch.inference.quantize import (
            _target_layers, quantize)
        if self._model is None:
            raise RuntimeError("load a model first")
        if not force:
            warnings.warn(
                "weight PTQ trades accuracy for weight bytes; see PERF.md "
                "for what it buys on this card — skipping quantization. "
                "Pass force=True to quantize anyway.", stacklevel=2)
            return self
        if not _target_layers(self._model, self._params or {}):
            return self                  # nothing quantizable
        quantize(self._model, calib_inputs, bits=bits,
                 group_size=group_size, percentile=percentile)
        self._refresh_params()
        self._reset_warm()               # the quantized model is a new program
        return self

    # -- predict ----------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        # a copy from pageable memory would first wait for every batch
        # already in flight; from pinned memory it queues behind them
        return t.pin_memory().to(self.device, non_blocking=True)

    def _forward(self, ts: List[torch.Tensor], s, multi: bool):
        """The padded forward on device tensors: a compact batch with
        per-row scales ``s`` is dequantized first."""
        with torch.inference_mode():
            if s is not None:
                x = ts[0]
                ts = [x.to(torch.float32)
                      * s.reshape(s.shape + (1,) * (x.ndim - 1))]
            return self._model(ts if multi else ts[0])

    @staticmethod
    def _signature(xs: List[np.ndarray], sc, multi: bool) -> tuple:
        return (multi, sc is not None,
                tuple((tuple(a.shape), np.dtype(a.dtype).str) for a in xs))

    @staticmethod
    def program_label(xs: List[np.ndarray], scales=None) -> str:
        """Program name matching the warm-up manifest's entries:
        ``b<bucket>x<tail shape>/<dtype>[+scales]``."""
        a = xs[0]
        tail = "x".join(str(int(s)) for s in a.shape[1:]) or "scalar"
        label = f"b{int(a.shape[0])}x{tail}/{np.dtype(a.dtype).str}"
        return label + "+scales" if scales is not None else label

    def _count_call(self, xs: List[np.ndarray], sc, multi: bool) -> None:
        """One execution of a padded batch: counted under its program
        label, and as a hit when its signature was warmed."""
        label = self.program_label(xs, sc)
        key = self._signature(xs, sc, multi)
        with self._warm_lock:
            self._execs[label] = self._execs.get(label, 0) + 1
            if key in self._warmed:
                self._hits += 1
            else:
                self._cold.add(key)

    def _padded_call(self, xs: List[np.ndarray], sc, multi: bool):
        """Enqueue ONE padded bucket batch: the arrays go to the device in
        their own dtype; a compact batch with per-row scales is
        dequantized there.  Returns device output(s) without waiting."""
        self._count_call(xs, sc, multi)
        ts = [self._to_device(a) for a in xs]
        s = None if sc is None else self._to_device(sc)
        return self._forward(ts, s, multi)

    # -- ahead-of-time warm-up --------------------------------------------------
    def _reset_warm(self) -> None:
        with self._warm_lock:
            self._epoch += 1
            self._warmed.clear()
            self._cold.clear()
            self._hits = 0
            self._execs.clear()

    def warm(self, bucket: int, shape, dtype: str = "<f4",
             scales: bool = False) -> bool:
        """Warm the program of one warm-up entry: the padded forward of a
        ``(bucket,) + shape`` batch of ``dtype`` (optionally the
        per-row-scales variant) runs once, so that its first-call setup
        (kernel attributes, cuBLAS heuristics and workspaces, the caching
        allocator's growth) is done before traffic.  Returns True when
        this call warmed the signature, False when it was warm already."""
        if self._model is None:
            raise RuntimeError("load a model first")
        x = np.zeros((int(bucket),) + tuple(int(s) for s in shape),
                     np.dtype(dtype))
        sc = np.ones((int(bucket),), np.float32) if scales else None
        key = self._signature([x], sc, False)
        with self._warm_lock:
            if key in self._warmed:
                return False
            epoch = self._epoch
        self._forward([self._to_device(x)],
                      None if sc is None else self._to_device(sc), False)
        with self._warm_lock:
            if self._epoch != epoch:
                return False           # re-loaded meanwhile: stale program
            self._warmed.add(key)
        return True

    def aot_stats(self) -> Dict:
        """Warm-up evidence since the last (re-)load: the epoch, the
        signatures that have had their first call (``cached_programs`` and
        ``compiles``: each one warmed, and each one first run cold, outside
        the warm-up, as a bucket past the warmed ladder is), the calls
        that found their signature warmed (``hits``) and executions per
        program label."""
        with self._warm_lock:
            seen = len(self._warmed | self._cold)
            return {"epoch": self._epoch,
                    "cached_programs": seen,
                    "hits": self._hits,
                    "compiles": seen,
                    "programs": dict(self._execs)}

    def capture(self, fn: Callable, inputs) -> "aot.CapturedProgram":
        """``aot.capture`` of ``fn(*inputs)`` on this model's device; the
        graph's pool then counts in ``aot_memory_bytes`` for as long as
        its owner holds it."""
        program = aot.capture(fn, inputs, self.device)
        with self._warm_lock:
            self._graphs.add(program)
        return program

    def aot_memory_bytes(self) -> Optional[int]:
        """Device bytes held by the memory pools of the CUDA graphs
        captured over this model and still alive: the growth of the
        caching allocator's reserved memory across each capture
        (``CapturedProgram.pool_bytes``), which the graph's replays
        reuse.  These graphs are the port's counterpart of the JAX
        package's compiled executables.  None where no graph is alive,
        as on the CPU, where nothing is captured."""
        with self._warm_lock:
            graphs = list(self._graphs)
        if not graphs:
            return None
        return sum(g.pool_bytes for g in graphs)

    class _Pending:
        """Handle for one dispatched batch: the device work is already
        enqueued; ``result()`` copies to the host and strips the bucket
        padding."""

        def __init__(self, device_out, take: int):
            self._out = device_out
            self._take = take

        def result(self):
            return _to_host(self._out, self._take)

    def _inputs(self, x, scales):
        if self._model is None:
            raise RuntimeError("load a model first")
        multi = isinstance(x, (list, tuple))
        if scales is not None and multi:
            raise ValueError("scales= supports single-input models only")
        xs = [np.asarray(a) for a in (x if multi else [x])]
        return xs, multi

    def dispatch(self, x, scales: Optional[np.ndarray] = None):
        """Enqueue ONE batch on the device without waiting for it; call
        ``.result()`` on the returned handle for the host outputs.  Pads to
        the same bucket as ``do_predict``.  No semaphore and no chunking:
        the caller (the engine's ``inflight_batches`` bound) caps open
        handles; a batch larger than ``max_batch`` is evaluated lazily
        through ``do_predict`` at ``result()``."""
        t0 = time.perf_counter()
        xs, multi = self._inputs(x, scales)
        n = xs[0].shape[0]
        if n > self.max_batch:
            return _LazyPending(lambda: self.do_predict(x, scales=scales))
        bucket = _bucket(n, self.max_batch)
        xs, sc = _pad_to_bucket(xs, scales, n, bucket)
        out = self._padded_call(xs, sc, multi)
        self._observe("dispatch", n, time.perf_counter() - t0)
        return self._Pending(out, n)

    def do_predict(self, x, batch_size: Optional[int] = None,
                   scales: Optional[np.ndarray] = None):
        """Batched forward with power-of-two bucket padding, in chunks of
        ``batch_size`` rows (at most ``max_batch``).  Up to
        ``supported_concurrent_num`` chunks stay in flight on the device
        before their host readback.  ``scales``: per-row dequantization
        factors for a compact int8/uint8 ``x`` (single-input models)."""
        t0 = time.perf_counter()
        xs, multi = self._inputs(x, scales)
        sc = None if scales is None else np.asarray(scales, np.float32)
        n = xs[0].shape[0]
        step = min(batch_size or self.max_batch, self.max_batch)
        outs = []
        pending: List = []       # (device output, take) not yet read back

        def drain_one():
            y, take = pending.pop(0)
            outs.append(_to_host(y, take))

        with self._sem:
            i = 0
            while i < n:
                take = min(step, n - i)
                bucket = _bucket(take, self.max_batch)
                chunk, schunk = _pad_to_bucket(
                    [a[i:i + take] for a in xs],
                    None if sc is None else sc[i:i + take], take, bucket)
                pending.append((self._padded_call(chunk, schunk, multi),
                                take))
                if len(pending) >= self.concurrent_num:
                    drain_one()
                i += take
            while pending:
                drain_one()
        self._observe("do_predict", n, time.perf_counter() - t0)
        if isinstance(outs[0], list):
            return [np.concatenate([o[j] for o in outs])
                    for j in range(len(outs[0]))]
        return np.concatenate(outs)

    # reference-style alias
    predict = do_predict
