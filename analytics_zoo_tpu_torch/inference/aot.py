"""Ahead-of-time warm-up for the serving plane: the warm-up manifests, and
the CUDA graphs that stand where the JAX package keeps compiled programs.

The JAX package's ``inference/aot.py`` compiles every program a deployment
can hit before traffic arrives, so a warm replica serves its first request
with zero compiles.  PyTorch runs eagerly: nothing is compiled, but every
op is a launch issued from Python.  Where the host's launch rate sets the
pace, as in a decode quantum, warming a program means capturing it as a
CUDA graph that later replays with one launch; a predict bucket, whose
batches keep the card busy, is warmed by running it once (its first-call
setup), as a replayed bucket gained too little to keep (PERF.md):

- ``warmup_manifest`` / ``resolve_manifest`` — the predict plane's set, one
  entry per ``(bucket, dtype, scales-variant)``, from the same bucket
  ladder ``do_predict`` and ``dispatch`` pad to (``bucket_ladder``);
  ``warm_up`` walks it through ``InferenceModel.warm`` (and a generation
  manifest through ``ContinuousBatcher.warm``'s entry function).
- ``generation_manifest`` — the continuous batcher's set, shared by
  ``ContinuousBatcher.warm`` and the engine's warm-up.
- ``capture`` / ``CapturedProgram`` — one captured graph with its static
  input and output tensors and its replays;
  ``CAPTURE_STATS`` counts captures, their seconds and replays for the
  process (in place of the JAX package's ``CompileStats``).

The manifest code is a copy of the JAX package's (its entries compare
equal); the XLA-only parts (compile listeners, the persistent compilation
cache) have no counterpart.
"""

from __future__ import annotations

import gc
import logging
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class WarmupEntry(NamedTuple):
    """One program of the predict warm-up set.  ``shape`` is the
    per-record tail shape (the batch axis is ``bucket``); ``scales`` marks
    the int8-wire variant that dequantizes on the device with per-row
    scales; ``mesh``/``sharding`` record the placement (always single-card
    here); ``variant`` the weights: ``float``, ``w8`` or ``w4``."""

    bucket: int
    shape: Tuple[int, ...]
    dtype: str                       # numpy dtype str of the wire batch
    scales: bool
    mesh: Optional[Tuple[int, int]]  # (data, model) axes, None = one card
    sharding: str                    # off | batch | tensor | hybrid
    variant: str = "float"


class GenWarmupEntry(NamedTuple):
    """One program of a generation deployment's warm-up set: one
    ``prefill`` per (admission batch, prompt bucket, lane), one ``insert``
    per (admission batch, lane) and one ``decode_step`` per lane; in paged
    mode one ``paged_decode`` per lane, one ``paged_prefill`` per (batch,
    prompt bucket) and one ``paged_shared`` per (batch, suffix bucket,
    prefix-table bucket)."""

    kind: str                        # prefill | decode_step | insert |
    #                                  paged_prefill | paged_shared |
    #                                  paged_decode
    prefill_bucket: Optional[int]    # prompt padding bucket (prefill only)
    lane_bucket: int                 # decode lane capacity bucket
    prefill_batch: Optional[int] = None   # admission batch bucket (pow-2)
    prefix_blocks: Optional[int] = None   # prefix-table bucket
    #                                       (paged_shared only)


class CaptureStats:
    """Process-wide graph accounting: graphs captured, the seconds their
    captures took, and replays.  ``warm_up`` and ``ContinuousBatcher.warm``
    report the delta of a pass as their ``compile_stats``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"captures": self.captures,
                    "capture_seconds": round(self.capture_seconds, 3),
                    "replays": self.replays}

    def note_capture(self, seconds: float) -> None:
        with self._lock:
            self.captures += 1
            self.capture_seconds += float(seconds)

    def note_replay(self) -> None:
        with self._lock:
            self.replays += 1


CAPTURE_STATS = CaptureStats()


def stats_delta(before: Dict[str, float]) -> Dict[str, float]:
    after = CAPTURE_STATS.snapshot()
    return {k: round(after[k] - before[k], 3) for k in after}


class CapturedProgram:
    """One captured CUDA graph.  ``inputs`` are the static device tensors
    it reads (fill them in place, on the stream, before ``replay``);
    ``output`` is what the captured function returned, static tensors that
    every replay overwrites; ``replays`` counts its replays.  Callers that
    share a program between threads serialize the fill, the replay and
    the read of ``output``.

    ``pool_bytes`` is the device memory the capture took from the device
    for the graph's private pool (the growth of
    ``torch.cuda.memory_reserved`` across the capture, from an emptied
    cache): the segments holding the intermediate and output tensors the
    graph's kernels write, reserved for its replays."""

    def __init__(self, graph, inputs, output, pool_bytes: int = 0):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.replays = 0
        self.pool_bytes = int(pool_bytes)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        CAPTURE_STATS.note_replay()
        return self.output


def capture(fn: Callable, inputs: Sequence[torch.Tensor],
            device: torch.device) -> CapturedProgram:
    """Capture ``fn(*inputs)`` as a CUDA graph on a side stream, in the
    thread-local capture mode (another thread's CUDA calls do not break
    the capture).  ``fn`` must have run eagerly at these shapes first:
    first-call setup (kernel attributes, library handles, lazy caches)
    cannot happen inside a capture.  A capture records and does not
    execute, so the kernel wrappers' launch counters add nothing for it
    (``ops/_impl.launched``); the replays launch the kernels, and
    ``ops/_impl.card_launches`` counts them on the card."""
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    graph = torch.cuda.CUDAGraph()
    # what torch.cuda.graph does on entry, done first so that the reserved
    # memory is measured from the emptied cache the capture starts from
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                              capture_error_mode="thread_local"):
            output = fn(*inputs)
    CAPTURE_STATS.note_capture(time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    return CapturedProgram(
        graph, tuple(inputs), output,
        pool_bytes=max(0, torch.cuda.memory_reserved(device) - reserved0))


# -- the predict plane's manifest -------------------------------------------

def bucket_ladder(max_batch: int,
                  model_cap: Optional[int] = None) -> List[int]:
    """Every bucket ``_bucket(n, cap)`` can produce for
    ``1 <= n <= max_batch`` — the exact set a deployment serving batches
    up to ``max_batch`` walks through.  ``model_cap`` is the model's pow-2
    ``max_batch`` ceiling; the ladder stops at the smaller of the two."""
    from analytics_zoo_tpu_torch.inference.inference_model import _bucket
    cap = int(model_cap) if model_cap is not None else int(max_batch)
    seen = []
    n = 1
    while n <= max(1, int(max_batch)):
        b = _bucket(n, cap)
        if b not in seen:
            seen.append(b)
        if n >= max_batch:
            break
        n = min(n * 2, int(max_batch))
    return sorted(seen)


def infer_input_spec(model) -> Optional[Tuple[Tuple[int, ...], str]]:
    """Per-record input spec ``(tail_shape, dtype)`` from the loaded
    topology's declared input shape; None when it declares none."""
    inner = getattr(model, "_model", None)
    shape = getattr(inner, "_declared_input_shape", None)
    if shape is None:
        return None
    try:
        return tuple(int(s) for s in shape), "<f4"
    except (TypeError, ValueError):
        return None


def warmup_manifest(model, input_shape=None, dtype: str = "<f4",
                    max_batch: Optional[int] = None,
                    scales: str = "auto",
                    scale_dtypes: Sequence[str] = ("|i1",)
                    ) -> List[WarmupEntry]:
    """The predict warm-up set for ``model`` as deployed: one entry per
    ``(bucket, dtype, scales-variant)``.  ``input_shape``/``dtype``
    describe ONE record on the wire (default: the topology's declared
    input shape, f32); ``max_batch`` the engine's batch ceiling (default:
    the model's own).  ``scales``: ``"off"`` plain entries only; ``"auto"``,
    ``"on"`` or ``"both"`` add a per-row-scales entry per bucket for each
    of ``scale_dtypes`` (every loaded model can be captured, so the JAX
    package's distinction for bridge models does not arise)."""
    if input_shape is None:
        spec = infer_input_spec(model)
        if spec is None:
            raise ValueError(
                "warmup_manifest: the model declares no input shape; pass "
                "input_shape=(d0, ...) for one record")
        input_shape, dtype = spec
    tail = tuple(int(s) for s in input_shape)
    cap = int(getattr(model, "max_batch", 1024) or 1024)
    mb = int(max_batch) if max_batch else cap
    want_scales = scales in ("auto", "on", "both")
    from analytics_zoo_tpu_torch.inference.quantize import quantized_bits
    variant = {8: "w8", 4: "w4"}.get(
        quantized_bits(getattr(model, "_params", None) or {}), "float")
    entries: List[WarmupEntry] = []
    for bucket in bucket_ladder(mb, model_cap=cap):
        entries.append(WarmupEntry(bucket, tail, np.dtype(dtype).str,
                                   False, None, "off", variant))
        if want_scales:
            for sdt in scale_dtypes:
                entries.append(WarmupEntry(bucket, tail,
                                           np.dtype(sdt).str, True,
                                           None, "off", variant))
    return entries


def resolve_manifest(model, warmup_spec) -> List[WarmupEntry]:
    """Manifest from a ``ServingParams.warmup`` value: ``True`` derives
    everything from the model, a spec dict ``{"shape", "dtype", "scales",
    "max_batch", "scale_dtypes"}`` overrides per key."""
    spec = warmup_spec if isinstance(warmup_spec, dict) else {}
    return warmup_manifest(
        model,
        input_shape=spec.get("shape"),
        dtype=str(spec.get("dtype", "<f4")),
        max_batch=spec.get("max_batch"),
        scales=str(spec.get("scales", "auto")),
        scale_dtypes=tuple(spec.get("scale_dtypes") or ("|i1",)))


def generation_manifest(prefill_buckets: Sequence[int],
                        lane_buckets: Sequence[int],
                        prefill_batches: Sequence[int] = (1,),
                        cache_model: bool = True,
                        paged: bool = False,
                        prefix_blocks: Sequence[int] = ()
                        ) -> List[GenWarmupEntry]:
    """The continuous-batching program set: for every decode lane its
    step program, plus per admission-batch bucket one insert and one
    prefill per prompt bucket (only buckets that fit the lane for cache
    models).  ``paged=True``: one ``paged_decode`` per lane, one
    ``paged_prefill`` per (batch, prompt bucket) and, with prefix sharing
    on (``prefix_blocks`` non-empty), one ``paged_shared`` per (batch,
    suffix bucket, prefix-table bucket)."""
    entries: List[GenWarmupEntry] = []
    for lane in sorted({int(b) for b in lane_buckets}):
        if paged:
            entries.append(GenWarmupEntry("paged_decode", None, lane))
            for bb in sorted({int(b) for b in prefill_batches}):
                for pb in sorted({int(b) for b in prefill_buckets}):
                    if pb > lane and cache_model:
                        continue
                    entries.append(GenWarmupEntry(
                        "paged_prefill", pb, lane, bb))
                    for npb in sorted({int(b) for b in prefix_blocks}):
                        entries.append(GenWarmupEntry(
                            "paged_shared", pb, lane, bb, npb))
            continue
        entries.append(GenWarmupEntry("decode_step", None, lane))
        for bb in sorted({int(b) for b in prefill_batches}):
            entries.append(GenWarmupEntry("insert", None, lane, bb))
            for pb in sorted({int(b) for b in prefill_buckets}):
                if pb <= lane or not cache_model:
                    entries.append(GenWarmupEntry("prefill", pb, lane, bb))
    return entries


def warm_up(model, manifest: Optional[Sequence] = None, progress=None,
            stop=None, warm_entry: Optional[Callable] = None,
            **manifest_kw) -> Dict:
    """Warm every entry of ``manifest`` (default: ``warmup_manifest``)
    through ``warm_entry(entry)`` (default: ``model.warm`` of the entry's
    bucket), which returns False for an entry already warm (``skipped``).
    ``ContinuousBatcher.warm`` walks a generation manifest through here
    with its own ``warm_entry``.  ``progress(done, total, entry)`` is
    called after each entry; ``stop()`` true ends the pass early.  Returns
    ``{"programs", "compiled", "skipped", "failed", "stopped", "seconds",
    "compile_stats"}``, with ``compile_stats`` the ``CAPTURE_STATS`` delta
    of the pass."""
    if manifest is None:
        manifest = warmup_manifest(model, **manifest_kw)
    if warm_entry is None:
        def warm_entry(entry):
            return model.warm(entry.bucket, entry.shape, dtype=entry.dtype,
                              scales=entry.scales)
    before = CAPTURE_STATS.snapshot()
    t0 = time.monotonic()
    compiled = skipped = failed = 0
    stopped = False
    for i, entry in enumerate(manifest):
        if stop is not None and stop():
            stopped = True
            break
        try:
            fresh = warm_entry(entry)
            compiled += 1 if fresh else 0
            skipped += 0 if fresh else 1
        except Exception as e:  # noqa: BLE001 — one bad entry must not
            # strand the rest of the set; that program runs eagerly
            failed += 1
            logger.warning("aot: warm-up entry %s failed (%s: %s)",
                           entry, type(e).__name__, e)
        if progress is not None:
            progress(i + 1, len(manifest), entry)
    stats = {"programs": len(manifest), "compiled": compiled,
             "skipped": skipped, "failed": failed, "stopped": stopped,
             "seconds": round(time.monotonic() - t0, 3),
             "compile_stats": stats_delta(before)}
    logger.info("aot: warm-up %d program(s) in %.2fs (%d fresh, %d warm "
                "already, %d failed; %s graph capture(s))",
                stats["programs"], stats["seconds"], compiled, skipped,
                failed, stats["compile_stats"]["captures"])
    return stats
