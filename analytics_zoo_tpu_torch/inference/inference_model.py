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
  (``inference/quantize.py``), served through the hand-written
  ``w8a8`` / ``w4a16`` CUDA kernels.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
Ahead-of-time warm-up, sharding, the weight store and the framework
bridges are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import threading
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
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
        self._sem = threading.BoundedSemaphore(self.concurrent_num)
        self.load_seconds: Optional[float] = None
        # predict/dispatch latency + batch-size histograms: bound lazily to
        # the serving engine's registry (or the process one); an explicit
        # registry stays pinned
        self._obs_registry = registry
        self._obs_registry_explicit = registry is not None
        self._obs = None

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
        from analytics_zoo_tpu_torch.utils.convert import export_params
        model = self._model
        if isinstance(model, Layer) and not isinstance(model, TransformerLM):
            self._params = export_params(model)
        else:
            self._params = dict(model.named_parameters())

    def do_load_model(self, model: torch.nn.Module, params=None):
        """Load an in-memory module: moved to this model's device and put
        in eval mode.  ``params`` — a JAX-layout param pytree of numpy
        arrays (``utils/convert.load_jax_params``) — replaces the module's
        own weights when given."""
        t0 = time.perf_counter()
        model = model.to(self.device).eval()
        if params is not None:
            from analytics_zoo_tpu_torch.utils.convert import load_jax_params
            load_jax_params(model, params)
        self._model = model
        self._refresh_params()
        self.load_seconds = time.perf_counter() - t0
        return self

    do_load = _not_ported("do_load (the weight store)")
    do_load_store = _not_ported("do_load_store (the mmap weight store)")
    do_load_tensorflow = _not_ported("the TensorFlow bridge")
    do_load_onnx = _not_ported("the ONNX bridge")
    do_load_pytorch = _not_ported("the TorchScript bridge")
    shard = _not_ported("sharded predict (multi-GPU)")
    warm = _not_ported("ahead-of-time warm-up")

    # -- quantization -------------------------------------------------------------
    def do_quantize(self, calib_inputs, force: bool = False, bits: int = 8,
                    group_size: int = 64,
                    percentile: Optional[float] = None):
        """Post-training weight quantization of the loaded model.

        ``bits=8`` (W8A8): ``calib_inputs`` — one batch or a list of
        batches — calibrates the per-layer activation scales
        (``percentile`` clips at that percentile of |x| instead of the
        absmax); Dense weights become int8 with per-output-channel scales.
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
        return self

    # -- predict ----------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        # a copy from pageable memory would first wait for every batch
        # already in flight; from pinned memory it queues behind them
        return t.pin_memory().to(self.device, non_blocking=True)

    def _padded_call(self, xs: List[np.ndarray], sc, multi: bool):
        """Enqueue ONE padded bucket batch: the arrays go to the device in
        their own dtype; a compact batch with per-row scales is
        dequantized there.  Returns device output(s) without waiting."""
        ts = [self._to_device(a) for a in xs]
        with torch.inference_mode():
            if sc is not None:
                s = self._to_device(sc)
                x = ts[0]
                ts = [x.to(torch.float32)
                      * s.reshape(s.shape + (1,) * (x.ndim - 1))]
            return self._model(ts if multi else ts[0])

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
