"""Estimator — the training/eval engine; the JAX package's
``estimator/estimator.py`` on one device.

The JAX Estimator jits a whole iteration — forward, backward, gradient
all-reduce, optimizer update — into one XLA program over the device mesh.
The port runs the same iteration eagerly on the model's own device:

- forward in training mode, with dropout seeded per step
  (``Layer.seed_dropout`` with ``split_seed(conf.seed, global_step)``, the
  JAX ``fold_in(PRNGKey(seed), global_step)``);
- the per-sample loss reduced as ``per.reshape(B, -1).mean(-1)``, then the
  weighted mean ``sum(per * w) / max(sum(w), 1e-8)``;
- ``backward()`` — attention's gradient goes through the flash backward
  kernels on the card (``ops/flash_attention.py``);
- the optax-semantics update of ``nn/optimizers.py`` over the parameter
  list, optionally clipped, applied in place.

The per-step loss stays a device tensor: the loop reads it back only every
``log_every`` steps and at the end of an epoch, as the JAX loop does.
Batches come from a ``FeatureSet`` in the JAX package's order (the same
shuffle generator, weight-0 padding of the last batch) and are copied to
the device from pinned memory on a worker thread (``_DevicePrefetcher``).

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: checkpointing with the failure-retry loop and the preemption guard,
TensorBoard summaries, ``steps_per_call > 1``, ``param_plan``,
multi-process training and ``profile_dir``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import get_context
from analytics_zoo_tpu_torch.common.triggers import TrainState, ZooTrigger
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet, FeatureSet
from analytics_zoo_tpu_torch.nn import metrics as metrics_lib
from analytics_zoo_tpu_torch.nn import objectives as objectives_lib
from analytics_zoo_tpu_torch.nn import optimizers as optimizers_lib
from analytics_zoo_tpu_torch.nn.module import Layer, split_seed

# batches the infeed thread keeps ready ahead of the step (double
# buffering, the JAX package's default)
_INFEED_DEPTH = 2
_CHECKPOINT = ("checkpointing, the failure-retry loop and the preemption "
               "guard (orbax in the JAX package): ROADMAP queue 1, item 6")


class _DevicePrefetcher:
    """Background-thread device infeed: host batch assembly and the host→device copy of up to ``depth`` upcoming
    batches run on a worker thread while the main thread's device work
    runs.  Exceptions raised by the iterator or the copy surface on the
    consumer thread; ``close()`` unblocks and joins the worker when the
    consumer stops early."""

    _SENTINEL = object()

    def __init__(self, iterator, transfer, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._err = None
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def work():
            try:
                for item in iterator:
                    if self._stop.is_set():
                        return
                    put(transfer(item))
            except BaseException as e:  # noqa: BLE001 — must cross threads
                self._err = e
            finally:
                # the sentinel must arrive or the consumer blocks forever
                put(self._SENTINEL)

        self._t = threading.Thread(target=work, daemon=True,
                                   name="zoo-infeed")
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        self._stop.set()
        while True:  # drain so a blocked put() wakes
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5.0)


class History:
    """fit() return value: per-epoch scalars (Keras History parity)."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, key: str, value: float):
        self.history.setdefault(key, []).append(float(value))

    def __repr__(self):
        return f"History({self.history})"


def _as_feature_set(x, y) -> FeatureSet:
    if isinstance(x, FeatureSet):
        return x
    return ArrayFeatureSet(x, y)


def _to_device(a, device: torch.device):
    """A host batch leaf (numpy array or list of them) as a tensor on
    ``device``: float64 becomes float32, as ``jnp.asarray`` makes it;
    CUDA copies go from pinned memory without blocking the host."""
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return [_to_device(v, device) for v in a]
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Estimator:
    """Uniform train/evaluate/predict facade over the model's device."""

    def __init__(self, model: Layer, optimizer=None, loss=None, metrics=(),
                 ctx=None, clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None, param_plan=None,
                 registry=None):
        if param_plan is not None:
            raise NotImplementedError(
                "param_plan (a tensor-parallel layout): ROADMAP queue 1, "
                "item 7")
        self.model = model
        self.ctx = ctx or get_context()
        opt = optimizers_lib.get(optimizer) if optimizer is not None \
            else None
        if opt is not None and (clip_norm or clip_value):
            opt = optimizers_lib.with_gradient_clipping(opt, clip_norm,
                                                        clip_value)
        self.optimizer = opt
        self.loss = objectives_lib.get(loss) if loss is not None else None
        self.metrics = [metrics_lib.get(m) for m in metrics]
        self.params: Optional[List[torch.Tensor]] = None
        self.opt_state = None
        self.global_step = 0
        self.epoch = 0
        self._listeners = []   # step-end callbacks: fn(step, loss tensor)
        self._obs_registry = registry
        self._fit_obs = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _fit_metrics_objs(self) -> Dict:
        """Lazily-registered fit metrics (get-or-create: several estimators
        in one process share the registry series)."""
        if self._fit_obs is None:
            from analytics_zoo_tpu_torch.common.observability import \
                get_registry
            reg = self._obs_registry or get_registry()
            self._obs_registry = reg
            self._fit_obs = {
                "step_time": reg.histogram(
                    "fit_step_seconds",
                    "Wall time per optimizer step (dispatch-side)"),
                "steps": reg.counter("fit_steps_total",
                                     "Optimizer steps run"),
                "samples": reg.counter("fit_samples_total",
                                       "Weighted training samples consumed"),
                "loss": reg.gauge("fit_loss", "Last recorded training loss"),
                "throughput": reg.gauge(
                    "fit_samples_per_second",
                    "Training throughput over the last epoch"),
            }
        return self._fit_obs

    def fit_summary(self) -> Dict:
        """Snapshot of the fit metrics in the registry: cumulative
        steps/samples, the step-time distribution, last loss, and
        last-epoch throughput."""
        obs = self._fit_metrics_objs()
        return {"steps": int(obs["steps"].value),
                "samples": obs["samples"].value,
                "step_time": obs["step_time"].snapshot(),
                "samples_per_second": obs["throughput"].value,
                "loss": obs["loss"].value}

    # -- configuration --------------------------------------------------------
    def set_checkpoint(self, directory: str,
                       trigger: Optional[ZooTrigger] = None,
                       keep: Optional[int] = None):
        raise NotImplementedError(_CHECKPOINT)

    def save_checkpoint(self, wait: bool = False):
        raise NotImplementedError(_CHECKPOINT)

    def maybe_restore_checkpoint(self) -> bool:
        raise NotImplementedError(_CHECKPOINT)

    def set_tensorboard(self, log_dir: str, app_name: str):
        raise NotImplementedError(
            "TensorBoard summaries (utils/tbwriter.py): ROADMAP queue 1, "
            "item 6")

    # -- initialisation -------------------------------------------------------
    def _ensure_init(self):
        """The parameter list, and the optimizer state on the parameters'
        device (the JAX ``_ensure_init``; a port model owns its
        parameters from construction)."""
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process training: ROADMAP queue 1, item 7")
        if self.params is not None:
            return
        self.params = list(self.model.parameters())
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init(self.params)

    # -- steps ------------------------------------------------------------------
    def _loss_sum(self, y_pred, y, w):
        """sum(per * w) of the per-sample loss, averaged over each
        sample's non-batch axes."""
        per = self.loss(y_pred, y)
        return (per.reshape(per.shape[0], -1).mean(dim=-1) * w).sum()

    def _train_step(self, x, y, w) -> torch.Tensor:
        self.model.seed_dropout(split_seed(self.ctx.conf.seed,
                                           self.global_step))
        for p in self.params:
            p.grad = None
        loss = self._loss_sum(self.model(x), y, w) / w.sum().clamp_min(1e-8)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        with torch.no_grad():
            updates = self.optimizer.update(grads, self.opt_state,
                                            self.params)
            optimizers_lib.apply_updates(self.params, updates)
        for p in self.params:
            p.grad = None
        return loss.detach()

    # -- public API -----------------------------------------------------------
    def fit(self, x, y=None, *, batch_size=32, epochs=1, validation_data=None,
            shuffle=True, verbose=True, log_every: int = 10,
            end_trigger: Optional[ZooTrigger] = None, resume: bool = False,
            steps_per_call: int = 1) -> History:
        if self.optimizer is None or self.loss is None:
            raise RuntimeError("Estimator needs optimizer and loss to fit")
        if resume:
            raise NotImplementedError(_CHECKPOINT)
        if steps_per_call != 1:
            raise NotImplementedError(
                "steps_per_call > 1 (several steps as one CUDA graph): "
                "ROADMAP queue 1, item 6")
        if self.ctx.conf.profile_dir:
            raise NotImplementedError(
                "profile_dir (a trace of the whole fit): ROADMAP queue 1, "
                "item 6")
        data = _as_feature_set(x, y)
        self._require_data(data)
        self._ensure_init()
        hist = History()
        np_rng = np.random.default_rng(self.ctx.conf.seed)
        tstate = TrainState(epoch=self.epoch, iteration=self.global_step)
        self.model.train()
        try:
            return self._fit_loop(data, batch_size, epochs, validation_data,
                                  shuffle, verbose, log_every, end_trigger,
                                  hist, np_rng, tstate)
        finally:
            self.model.eval()

    def _transfer(self, item):
        bx, by, bw = item
        dev = self.device
        return (_to_device(bx, dev), _to_device(by, dev),
                _to_device(bw, dev), float(bw.sum()))

    def _fit_loop(self, data, batch_size, epochs, validation_data, shuffle,
                  verbose, log_every, end_trigger, hist, np_rng,
                  tstate) -> History:
        obs = self._fit_metrics_objs()
        epoch = 0
        while epoch < epochs:
            t0 = time.time()
            losses, seen = [], 0
            t_step = time.perf_counter()
            feed = _DevicePrefetcher(
                data.batches(batch_size, shuffle=shuffle, rng=np_rng,
                             pad_final=True), self._transfer, _INFEED_DEPTH)
            try:
                for sx, sy, sw, wsum in feed:
                    loss = self._train_step(sx, sy, sw)
                    self.global_step += 1
                    losses.append(loss)
                    seen += int(wsum)
                    # per-step wall time on the dispatch side (no device
                    # sync), cumulative step/sample counters
                    now_step = time.perf_counter()
                    obs["step_time"].observe(now_step - t_step)
                    obs["steps"].inc(1)
                    obs["samples"].inc(wsum)
                    t_step = now_step
                    tstate.iteration = self.global_step
                    tstate.epoch_finished = False
                    if self.global_step % log_every == 0:
                        lf = float(loss)
                        tstate.loss = lf
                        obs["loss"].set(lf)
                    for fn in self._listeners:
                        fn(self.global_step, loss)
                    if end_trigger is not None and end_trigger(tstate):
                        break
            finally:
                feed.close()

            self.epoch += 1
            epoch += 1
            tstate.epoch = self.epoch
            tstate.epoch_finished = True
            mean_loss = float(torch.stack(losses).mean()) if losses \
                else float("nan")
            tstate.loss = mean_loss
            dt = time.time() - t0
            throughput = seen / max(dt, 1e-9)
            hist.append("loss", mean_loss)
            hist.append("throughput", throughput)
            if mean_loss == mean_loss:       # not NaN (empty epoch)
                obs["loss"].set(mean_loss)
            obs["throughput"].set(throughput)
            msg = (f"Epoch {self.epoch} ({epoch}/{epochs}) - loss "
                   f"{mean_loss:.4f} - {throughput:.0f} samples/s")
            if validation_data is not None:
                val = self.evaluate(*self._val_tuple(validation_data),
                                    batch_size=batch_size)
                self.model.train()
                for k, v in val.items():
                    hist.append("val_" + k, v)
                tstate.score = next(iter(val.values())) if val else None
                msg += " - " + " ".join(f"val_{k} {v:.4f}"
                                        for k, v in val.items())
            if verbose:
                print(msg)
            if end_trigger is not None and end_trigger(tstate):
                break
        return hist

    @staticmethod
    def _val_tuple(validation_data):
        if isinstance(validation_data, FeatureSet):
            return validation_data, None
        return validation_data[0], (validation_data[1]
                                    if len(validation_data) > 1 else None)

    @staticmethod
    def _require_data(data: FeatureSet):
        if data.size() <= 0:
            raise ValueError("empty data: got size()=0")

    @torch.no_grad()
    def evaluate(self, x, y=None, *, batch_size=32) -> Dict[str, float]:
        data = _as_feature_set(x, y)
        self._require_data(data)
        self._ensure_init()
        self.model.eval()
        accs = [m.init() for m in self.metrics]
        # accumulate on the device; one readback at the end
        loss_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device)
        feed = _DevicePrefetcher(data.batches(batch_size, pad_final=True),
                                 self._transfer, _INFEED_DEPTH)
        try:
            for sx, sy, sw, _ in feed:
                y_pred = self.model(sx)
                accs = [m.update(acc, y_pred, sy, sw)
                        for m, acc in zip(self.metrics, accs)]
                if self.loss is not None:
                    loss_sum = loss_sum + self._loss_sum(y_pred, sy, sw)
                w_sum = w_sum + sw.sum()
        finally:
            feed.close()
        out = {m.name: m.result(acc) for m, acc in zip(self.metrics, accs)}
        w = float(w_sum)
        if self.loss is not None and w > 0:
            out["loss"] = float(loss_sum) / w
        return out

    @torch.no_grad()
    def predict(self, x, *, batch_size=128) -> np.ndarray:
        data = _as_feature_set(x, None)
        self._require_data(data)
        self._ensure_init()
        self.model.eval()
        outs = []
        n_left = data.size()

        def readback(yb, nb):
            nonlocal n_left
            take = min(n_left, nb)
            if isinstance(yb, (list, tuple)):
                outs.append([a[:take].cpu().numpy() for a in yb])
            else:
                outs.append(yb[:take].cpu().numpy())
            n_left -= take

        feed = _DevicePrefetcher(data.batches(batch_size, pad_final=True),
                                 lambda b: (_to_device(b[0], self.device),
                                            int(b[2].shape[0])),
                                 _INFEED_DEPTH)
        pending = None  # one-batch-lag readback: batch k's host copy
        try:            # waits behind batch k+1's device work
            for sx, nb in feed:
                yb = self.model(sx)
                if pending is not None:
                    readback(*pending)
                pending = (yb, nb)
        finally:
            feed.close()
        if pending is not None:
            readback(*pending)
        if isinstance(outs[0], list):
            return [np.concatenate([o[i] for o in outs])
                    for i in range(len(outs[0]))]
        return np.concatenate(outs)

    # -- reference-named aliases ---------------------------------------------
    def train(self, train_set: FeatureSet, *, batch_size=32, end_epoch=1,
              validation_set: Optional[FeatureSet] = None, **kw) -> History:
        """Estimator.train parity (Estimator.scala:118-155)."""
        return self.fit(train_set, batch_size=batch_size, epochs=end_epoch,
                        validation_data=validation_set, **kw)
