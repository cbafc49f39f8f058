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

``steps_per_call = k > 1`` groups k consecutive batches (a short final
group keeps its size); triggers, the preemption check and ``end_trigger``
fire once a group, as in JAX, and listeners are called for each of the
group's steps at its end.  On the CPU, and for a model with a layer set
to ``impl="torch"``, a group runs as k ordinary steps.  On the card it
runs as one CUDA graph of k whole steps (``_GraphSteps``): the first
group at new shapes runs eagerly (the warm-up a capture needs), then a
graph is captured once for each group size and replayed for every group
of that size, its inputs and step scalars copied in before each replay.

Subsystems, as in the JAX package: checkpoints on a trigger
(``estimator/checkpoint.py``), ``fit(resume=True)``, the failure-retry
loop (``conf.failure_retry_times``: restore the latest snapshot and run
the epoch again), the SIGTERM / SIGINT preemption guard, TensorBoard
event files (``utils/tbwriter.py``), and a ``torch.profiler`` trace of a
whole fit under ``conf.profile_dir``.

Several processes (one a GPU, ``common/context.py``'s world and mesh),
as in the JAX multi-host Estimator:

- each rank feeds the rows of its ``data`` coordinate (its process-local
  partition; ranks that share the coordinate feed the same rows):
  ``batch_size`` is the global batch, each rank's feed batch
  ``batch_size / data``; short partitions are padded with weight-0
  batches up to the longest one's count, so every rank runs the same
  steps (``_sync_batch_count``);
- with a ``seq`` axis > 1 the token axis of the model input, and of every
  array whose axis 1 has its length, is sharded over ``seq``
  (``ZooContext.batch_sharding_for``) and the forward runs inside
  ``parallel/ring_attention.sequence_sharded``;
- ``param_plan`` (a ``parallel/sharding.ShardingPlan``) puts the model
  into its parallel form before the first step;
- the loss is the weighted mean over the GLOBAL batch: each rank's share
  is ``sum(per · w) / W``, W the weights summed over ``data``, and a
  sample's mean over its tokens counts all its ``seq`` shards; the
  gradients (and the reported loss) are summed over ``data`` and
  ``seq``, never averaged again.  Gradients along ``model``, ``pipe`` and
  ``expert`` come out whole from the parallel forms' collectives, and
  global-norm clipping sums the squares of sharded leaves over their
  axes.

``steps_per_call = k`` keeps its CUDA graph where every collective can be
captured (NCCL).  A gloo world stages CUDA tensors through host memory,
so its groups run eagerly, as on the CPU; ``fit_summary()["route"]``
says which route the last fit took.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import (DATA_AXIS, SEQ_AXIS,
                                                    get_context)
from analytics_zoo_tpu_torch.common.resilience import RetryPolicy
from analytics_zoo_tpu_torch.common.triggers import (EveryEpoch, TrainState,
                                                     ZooTrigger)
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet, FeatureSet
from analytics_zoo_tpu_torch.nn import metrics as metrics_lib
from analytics_zoo_tpu_torch.nn import objectives as objectives_lib
from analytics_zoo_tpu_torch.nn import optimizers as optimizers_lib
from analytics_zoo_tpu_torch.nn.module import (Layer, generator_hook,
                                               split_seed)

logger = logging.getLogger(__name__)

# batches the infeed thread keeps ready ahead of the step (double
# buffering, the JAX package's default)
_INFEED_DEPTH = 2


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


class _PreemptionGuard:
    """SIGTERM/SIGINT-aware checkpointing (the JAX ``_PreemptionGuard``).

    Preemptions arrive as SIGTERM.  While a fit() with checkpointing is
    active, the first SIGTERM/SIGINT only sets a flag; the loop notices it
    at the next step (or group) boundary, writes a synchronous snapshot,
    then exits with 128+SIGTERM (so a supervisor restarts with
    resume=True) or raises KeyboardInterrupt (SIGINT keeps its meaning
    for the caller's cleanup code).  A second signal falls through to the
    previous disposition (force kill).  No-op off the main thread
    (signal() is main-thread-only)."""

    def __init__(self):
        self.fired: Optional[int] = None
        self._prev = {}

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # not installable here
                pass
        return self

    def _handle(self, signum, frame):
        if self.fired is not None:       # second signal: previous behaviour
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            if callable(prev):
                prev(signum, frame)
            else:
                # SIG_DFL/SIG_IGN aren't callable: re-deliver so the
                # process dies BY the signal, which supervisors key on
                os.kill(os.getpid(), signum)
            return
        self.fired = signum

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


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


def _tmap(fn, *trees):
    """``fn`` over the tensors of batch trees (a tensor, None, or a list
    of them)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], (list, tuple)):
        return [_tmap(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def _signature(tree):
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(t) for t in tree)
    return tuple(tree.shape), tree.dtype


class _DropoutSites:
    """A generator hook (``nn/module.generator_hook``) that runs a step
    as usual and notes, in call order, which ``(layer, index)`` seeded
    each generator the step drew from: the dropout sites a captured step
    must reseed.  ``sites`` is None when a generator's seed came from no
    ``train_seed`` (the step cannot be reseeded)."""

    def __init__(self):
        self.by_seed: Dict[int, tuple] = {}
        self.sites: Optional[list] = []

    def seed(self, layer, index, seed):
        self.by_seed[seed] = (layer, index)

    def generator(self, seed, device):
        site = self.by_seed.get(seed)
        if site is None or self.sites is None:
            self.sites = None
        else:
            self.sites.append(site)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen


class _GraphGenerators:
    """The generator hook of a capture: step i's j-th draw takes
    ``gens[i][j]``, a generator registered with the graph."""

    def __init__(self, gens):
        self.gens, self.step, self.j = gens, 0, 0

    def seed(self, layer, index, seed):
        pass

    def generator(self, seed, device):
        gen = self.gens[self.step][self.j]
        self.j += 1
        return gen


class _GraphSteps:
    """One fit's CUDA-graph route for groups of steps.

    A group at shapes not seen yet runs as eager steps, which warm up
    what a capture cannot do (kernel libraries, cuBLAS handles, the
    autograd engine) and note the step's dropout sites.  Later groups run
    as one captured graph of k whole steps for each group size k: the
    forward, the backward (flash kernels included), clipping and the
    optimizer update, writing the parameters and the optimizer state in
    place.  Before each replay the host copies the group's batches into
    the graph's static inputs, writes each step's step scalars (learning
    rate, bias corrections: ``nn/optimizers``) into a (k, n) buffer and
    reseeds the generators registered for the dropout sites with the
    seeds the eager steps would use, so step s draws the same masks on
    both routes.  The k losses come out as one static (k,) tensor.  The
    graphs share one memory pool and live as long as the fit."""

    def __init__(self, est: "Estimator"):
        self.est = est
        self.pool = torch.cuda.graph_pool_handle()
        self.sites: Dict = {}          # shapes -> dropout sites, or None
        self.graphs: Dict = {}         # (k, shapes) -> program

    def run(self, group) -> List[torch.Tensor]:
        est = self.est
        sig = _signature(group[0][:3])
        if sig not in self.sites:
            rec = _DropoutSites()
            with generator_hook(rec):
                losses = est._eager_group(group)
            self.sites[sig] = rec.sites
            return losses
        sites = self.sites[sig]
        k = len(group)
        prog = self.graphs.get((k, sig))
        if prog is None:
            if sites is None or (sites and not hasattr(
                    torch.cuda.CUDAGraph, "register_generator_state")):
                return est._eager_group(group)
            prog = self.graphs[(k, sig)] = self._capture(group, sites)
        xs, ys, ws, scal, gens = prog.inputs
        for i, (sx, sy, sw, *_) in enumerate(group):
            for dst, src in ((xs[i], sx), (ys[i], sy), (ws[i], sw)):
                _tmap(lambda d, s: d.copy_(s), dst, src)
        rows = [est.optimizer.step_scalars(est.opt_state) for _ in range(k)]
        scal.copy_(torch.tensor(rows, dtype=torch.float32).reshape(
            scal.shape))
        if sites:
            for i in range(k):
                est._seed_step(est.global_step + i)
                for gen, (layer, index) in zip(gens[i], sites):
                    gen.manual_seed(layer.train_seed(index))
        losses = prog.replay().clone()
        est.global_step += k
        return list(losses.unbind())

    def _capture(self, group, sites):
        from analytics_zoo_tpu_torch.inference import aot
        est = self.est
        dev = est.device
        k = len(group)
        xs, ys, ws = ([_tmap(torch.empty_like, b[j]) for b in group]
                      for j in range(3))
        scal = torch.zeros((k, est.optimizer.n_scalars),
                           dtype=torch.float32, device=dev)
        gens = [[torch.Generator(device=dev) for _ in sites]
                for _ in range(k)]
        hook = _GraphGenerators(gens)

        def steps(*_):
            losses = []
            for i in range(k):
                hook.step, hook.j = i, 0
                est._seed_step(est.global_step + i)
                losses.append(est._step_body(xs[i], ys[i], ws[i],
                                             list(scal[i].unbind())))
            return torch.stack(losses)

        with generator_hook(hook):
            return aot.capture(steps, (xs, ys, ws, scal, gens), dev,
                               pool=self.pool,
                               generators=[g for row in gens for g in row])


class Estimator:
    """Uniform train/evaluate/predict facade over the model's device."""

    def __init__(self, model: Layer, optimizer=None, loss=None, metrics=(),
                 ctx=None, clip_norm: Optional[float] = None,
                 clip_value: Optional[float] = None, param_plan=None,
                 registry=None):
        self.model = model
        self.param_plan = param_plan
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
        self._ckpt_mgr = None
        self._ckpt_trigger: Optional[ZooTrigger] = None
        self._guard: Optional[_PreemptionGuard] = None
        self._tb_writer = None
        self._tb_val_writer = None
        self.profile_path: Optional[str] = None   # the last fit's trace
        self._obs_registry = registry
        self._fit_obs = None
        self.route: Optional[str] = None   # the last fit's: graph | eager
        # the global token length of the batch being stepped, when its
        # tokens are sharded over seq (else None)
        self._seq_total: Optional[int] = None

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
                "loss": obs["loss"].value, "route": self.route}

    # -- configuration --------------------------------------------------------
    def set_checkpoint(self, directory: str,
                       trigger: Optional[ZooTrigger] = None,
                       keep: Optional[int] = None):
        """Checkpoint on trigger (KerasNet.setCheckpoint parity); the
        ``keep`` newest snapshots stay (default ``conf.checkpoint_keep``)."""
        from analytics_zoo_tpu_torch.estimator.checkpoint import \
            CheckpointManager
        self._ckpt_mgr = CheckpointManager(
            directory, keep or self.ctx.conf.checkpoint_keep)
        self._ckpt_trigger = trigger or EveryEpoch()
        return self

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Scalar summaries: Loss/Throughput + validation metrics
        (KerasNet.setTensorBoard parity, Topology.scala:206-238)."""
        from analytics_zoo_tpu_torch.utils.tbwriter import FileWriter
        base = os.path.join(log_dir, app_name)
        self._tb_writer = FileWriter(os.path.join(base, "train"))
        self._tb_val_writer = FileWriter(os.path.join(base, "validation"))
        return self

    # -- initialisation -------------------------------------------------------
    def _ensure_init(self):
        """The parameter list, and the optimizer state on the parameters'
        device (the JAX ``_ensure_init``; a port model owns its
        parameters from construction).  A ``param_plan`` first puts the
        model into its parallel form, each rank keeping its slices."""
        if self.params is not None:
            return
        mesh = self.ctx.mesh
        if self.param_plan is not None \
                and getattr(self.model, "shard_layout", None) is None:
            self.param_plan.shard(self.model, mesh)
        self.params = list(self.model.parameters())
        # gradients and the loss are summed over the axes along which
        # each rank's loss is its share (a world of one keeps data's)
        self._reduce_axes = [a for a in (DATA_AXIS, SEQ_AXIS)
                             if mesh.group(a) is not None]
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init(self.params)
            self._shard_aware_clipping()

    def _shard_aware_clipping(self):
        """Global-norm clipping over sharded leaves: a leaf split over an
        axis adds its squares summed over that axis's ranks (replicated
        leaves count once)."""
        axes_of = [tuple(getattr(p, "_zoo_shard_axes", ()))
                   for p in self.params]
        if not any(axes_of):
            return
        from analytics_zoo_tpu_torch.parallel import comm
        mesh = self.ctx.mesh
        groups: Dict[tuple, List[int]] = {}
        for i, axes in enumerate(axes_of):
            groups.setdefault(axes, []).append(i)

        def total_sq(sq):
            out = None
            for axes, idx in groups.items():
                part = torch.stack([sq[i] for i in idx]).sum()
                if axes:
                    part = comm.all_reduce_(part, axes, mesh)
                out = part if out is None else out + part
            return out

        for t in optimizers_lib.transforms(self.optimizer):
            if isinstance(t, optimizers_lib.ClipByGlobalNorm):
                t.reduce_sq = total_sq

    # -- checkpoint save/restore ----------------------------------------------
    def _ckpt_tree(self) -> Dict:
        """The live training state, as the checkpoint holds it: the
        parameters, the optimizer state (tensors and step counts), the
        model's buffers (BN statistics), the step and the epoch."""
        return {"params": self.params, "opt_state": self.opt_state,
                "model_state": dict(self.model.named_buffers()),
                "global_step": self.global_step,
                "extra": {"epoch": self.epoch}}

    def save_checkpoint(self, wait: bool = False):
        if self._ckpt_mgr is None:
            raise RuntimeError("call set_checkpoint(dir) first")
        self._ensure_init()
        tree = self._ckpt_tree()
        self._ckpt_mgr.save(self.global_step, tree["params"],
                            tree["opt_state"], tree["model_state"],
                            extra=tree["extra"], wait=wait)

    def maybe_restore_checkpoint(self) -> bool:
        """Restore the latest snapshot if one exists (resume/retry path):
        its tensors are copied into the live parameters, optimizer state
        and buffers in place, so a captured graph keeps reading them."""
        if self._ckpt_mgr is None or self._ckpt_mgr.latest_step() is None:
            return False
        self._ensure_init()
        restored = self._ckpt_mgr.restore(self._ckpt_tree())
        self.opt_state = restored["opt_state"]
        self.global_step = int(restored["global_step"])
        self.epoch = int(restored["extra"]["epoch"])
        return True

    # -- steps ------------------------------------------------------------------
    def _loss_sum(self, y_pred, y, w):
        """sum(per * w) of the per-sample loss, averaged over each
        sample's non-batch axes (all its ``seq`` shards' elements when
        the batch's tokens are sharded)."""
        per = self.loss(y_pred, y)
        mean = per.reshape(per.shape[0], -1).mean(dim=-1)
        if self._seq_total is not None:
            mean = mean / self.ctx.mesh.size(SEQ_AXIS)
        return (mean * w).sum()

    def _forward(self, x):
        """The model on a batch; a seq-sharded batch runs inside
        ``sequence_sharded``."""
        if self._seq_total is None:
            return self.model(x)
        from analytics_zoo_tpu_torch.parallel.ring_attention import \
            sequence_sharded
        with sequence_sharded(self.ctx.mesh, self._seq_total):
            return self.model(x)

    def _global_weight(self, w) -> torch.Tensor:
        """The weights summed over the global batch (``data``'s ranks)."""
        wsum = w.sum()
        if DATA_AXIS in self._reduce_axes:
            from analytics_zoo_tpu_torch.parallel import comm
            wsum = comm.all_reduce_(wsum.clone(), (DATA_AXIS,),
                                    self.ctx.mesh)
        return wsum

    def _reduce_grads(self, grads, loss):
        """Sum the gradients and the loss share over the reduce axes, in
        one all-reduce of a flat buffer; returns the global loss."""
        from analytics_zoo_tpu_torch.parallel import comm
        mesh = self.ctx.mesh
        if len({g.dtype for g in grads} | {loss.dtype}) > 1:
            for g in grads:
                comm.all_reduce_(g, self._reduce_axes, mesh)
            return comm.all_reduce_(loss.detach().clone(),
                                    self._reduce_axes, mesh)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        comm.all_reduce_(flat, self._reduce_axes, mesh)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return flat[-1]

    def _seed_step(self, step: int):
        self.model.seed_dropout(split_seed(self.ctx.conf.seed, step))

    def _step_body(self, x, y, w, scalars=None) -> torch.Tensor:
        """Forward, backward and the in-place update of one step; the
        optimizer's step scalars are its own (None) or the given 0-dim
        tensors.  Nothing reads the device back."""
        for p in self.params:
            p.grad = None
        loss = self._loss_sum(self._forward(x), y, w) \
            / self._global_weight(w).clamp_min(1e-8)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        with torch.no_grad():
            if self._reduce_axes:
                loss = self._reduce_grads(grads, loss)
            if scalars is None:
                updates = self.optimizer.update(grads, self.opt_state,
                                                self.params)
            else:
                updates = self.optimizer.apply(grads, self.opt_state,
                                               self.params, scalars)
            optimizers_lib.apply_updates(self.params, updates)
        for p in self.params:
            p.grad = None
        return loss.detach()

    def _train_step(self, x, y, w) -> torch.Tensor:
        self._seed_step(self.global_step)
        return self._step_body(x, y, w)

    def _eager_group(self, group) -> List[torch.Tensor]:
        losses = []
        for sx, sy, sw, *_ in group:
            losses.append(self._train_step(sx, sy, sw))
            self.global_step += 1
        return losses

    def _graph_route(self) -> bool:
        """Groups of steps run as CUDA graphs: on the card, unless a
        layer is set to its plain version or a collective of the fit goes
        through host memory (a gloo group)."""
        if self.device.type != "cuda" or any(
                getattr(m, "impl", None) == "torch"
                for m in self.model.modules()):
            return False
        return not any(torch.distributed.get_backend(g) == "gloo"
                       for g in self.ctx.mesh._groups.values())

    # -- public API -----------------------------------------------------------
    def fit(self, x, y=None, *, batch_size=32, epochs=1, validation_data=None,
            shuffle=True, verbose=True, log_every: int = 10,
            end_trigger: Optional[ZooTrigger] = None, resume: bool = False,
            steps_per_call: int = 1) -> History:
        """``steps_per_call`` > 1 runs that many optimizer steps a group,
        on the card as one CUDA graph (triggers and listeners then fire
        at group granularity)."""
        if self.optimizer is None or self.loss is None:
            raise RuntimeError("Estimator needs optimizer and loss to fit")
        if int(steps_per_call) < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")
        data = _as_feature_set(x, y)
        self._require_data(data)
        self._ensure_init()
        if resume:
            self.maybe_restore_checkpoint()
        hist = History()
        np_rng = np.random.default_rng(self.ctx.conf.seed)
        tstate = TrainState(epoch=self.epoch, iteration=self.global_step)
        profile_cm = (self._profile(self.ctx.conf.profile_dir)
                      if self.ctx.conf.profile_dir
                      else contextlib.nullcontext())
        # the preemption guard only with checkpointing configured; without
        # it, Ctrl-C keeps its normal KeyboardInterrupt semantics
        guard_cm = (_PreemptionGuard() if self._ckpt_mgr is not None
                    else contextlib.nullcontext())
        graphs = (_GraphSteps(self) if steps_per_call > 1
                  and self._graph_route() else None)
        self.route = "graph" if graphs is not None else "eager"
        self.model.train()
        with profile_cm, guard_cm as guard:
            self._guard = guard
            try:
                return self._fit_loop(data, batch_size, epochs,
                                      validation_data, shuffle, verbose,
                                      log_every, end_trigger,
                                      int(steps_per_call), graphs, hist,
                                      np_rng, tstate)
            finally:
                self._guard = None
                self.model.eval()
                if self._ckpt_mgr is not None:
                    self._ckpt_mgr.wait()    # commit in-flight async saves

    @contextlib.contextmanager
    def _profile(self, out_dir: str):
        """A ``torch.profiler`` trace of the block (the card's kernels
        too on a CUDA model), written as a Chrome trace
        ``fit-<time>-<pid>.json`` under ``out_dir``.  On the card the
        session warms up and settles first (``ops/_impl.settled_trace``):
        a trace that records at once can lose its first kernels' records.
        It holds ``ops/_impl.PROFILER_LOCK``, the process's one profiler
        session: while another session records, the fit raises and
        records nothing."""
        from torch.profiler import ProfilerActivity, profile

        from analytics_zoo_tpu_torch.ops import _impl
        if torch.autograd._profiler_enabled() \
                or not _impl.PROFILER_LOCK.acquire(blocking=False):
            raise RuntimeError(
                "profile_dir: another profiler session records in this "
                "process — one at a time")
        try:
            os.makedirs(out_dir, exist_ok=True)
            if self.device.type == "cuda":
                session = _impl.settled_trace([ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
            else:
                session = profile(activities=[ProfilerActivity.CPU])
            with session as prof:
                yield
            self.profile_path = os.path.join(
                out_dir, f"fit-{time.strftime('%Y%m%d-%H%M%S')}-"
                         f"{os.getpid()}.json")
            prof.export_chrome_trace(self.profile_path)
        finally:
            _impl.PROFILER_LOCK.release()

    def _feed_batch(self, batch_size: int) -> int:
        """This rank's feed batch: the global ``batch_size`` (rounded up
        to a multiple of the data axis) over the data axis."""
        dp = self.ctx.data_parallel_size
        return -(-int(batch_size) // dp)

    def _seq_view(self, bx, by):
        """This rank's token block of a host batch when the mesh shards
        tokens over seq: every array whose axis 1 is the model input's
        token axis (``batch_sharding_for``); returns (x, y, the global
        token length or None)."""
        mesh = self.ctx.mesh
        n = mesh.size(SEQ_AXIS)
        if n == 1:
            return bx, by, None
        leaves = bx if isinstance(bx, (list, tuple)) else [bx]
        first = next((a for a in leaves if np.ndim(a) >= 2), None)
        if first is None:
            return bx, by, None
        t = int(np.shape(first)[1])
        if "seq" not in self.ctx.batch_sharding_for(np.shape(first), t):
            return bx, by, None
        tl, i = t // n, mesh.index(SEQ_AXIS)

        def cut(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return [cut(v) for v in a]
            return a[:, i * tl:(i + 1) * tl] if np.ndim(a) >= 2 \
                and np.shape(a)[1] == t else a
        x, y = cut(bx), cut(by)
        ys = y if isinstance(y, (list, tuple)) else [y]
        if any(v is not None and (np.ndim(v) < 2 or np.shape(v)[1] != tl)
               for v in ys):
            raise NotImplementedError(
                "a sequence-sharded fit needs labels aligned with the "
                f"tokens ((B, {t}, ...)); got label shapes "
                f"{[np.shape(v) for v in ys if v is not None]}")
        return x, y, t

    def _transfer(self, item):
        bx, by, bw = item
        bx, by, total = self._seq_view(bx, by)
        dev = self.device
        return (_to_device(bx, dev), _to_device(by, dev),
                _to_device(bw, dev), float(bw.sum()), total)

    def _global_batches(self, local_n: int, feed_bs: int) -> Optional[int]:
        """Every rank's batch count this epoch: the longest partition's
        (None in one process).  Runs on the caller's thread: the infeed
        thread issues no collective."""
        if not self.ctx.is_multi_host:
            return None
        from analytics_zoo_tpu_torch.parallel import comm
        counts = comm.all_gather_object(int(local_n), mesh=self.ctx.mesh)
        return -(-max(counts) // feed_bs)

    @staticmethod
    def _sync_batch_count(batch_iter, feed_bs: int, target: Optional[int]):
        """Pad a short partition's batches with weight-0 copies of its
        last batch up to ``target``, so every rank dispatches the same
        number of collective steps (the zero weights mask them out of
        the loss like the in-batch pad rows)."""
        done, template = 0, None
        for item in batch_iter:
            template = item
            done += 1
            yield item
        if target is None:
            return
        bx, by, _ = template
        for _ in range(target - done):
            yield (bx, by, np.zeros((feed_bs,), np.float32))

    def _fit_loop(self, data, batch_size, epochs, validation_data, shuffle,
                  verbose, log_every, end_trigger, k, graphs, hist, np_rng,
                  tstate) -> History:
        obs = self._fit_metrics_objs()
        conf = self.ctx.conf
        retries_left = conf.failure_retry_times
        epoch = 0
        while epoch < epochs:
            t0 = time.time()
            losses, seen = [], 0
            t_step = time.perf_counter()
            feed_bs = self._feed_batch(batch_size)
            target = self._global_batches(data.size(), feed_bs)
            feed = _DevicePrefetcher(
                self._grouped(self._sync_batch_count(
                    data.batches(feed_bs, shuffle=shuffle, rng=np_rng,
                                 pad_final=True), feed_bs, target), k),
                lambda grp: [self._transfer(b) for b in grp], _INFEED_DEPTH)
            try:
                for group in feed:
                    step0 = self.global_step
                    self._seq_total = group[0][4]
                    ls = (graphs.run(group) if graphs is not None
                          else self._eager_group(group))
                    n = len(ls)
                    losses.extend(ls)
                    wsum = sum(b[3] for b in group)
                    seen += int(wsum)
                    # per-step wall time on the dispatch side (a group
                    # spreads its wall over its steps), cumulative
                    # step/sample counters
                    now_step = time.perf_counter()
                    obs["step_time"].observe((now_step - t_step) / n, n=n)
                    obs["steps"].inc(n)
                    obs["samples"].inc(wsum)
                    t_step = now_step
                    tstate.iteration = self.global_step
                    tstate.epoch_finished = False
                    if self.global_step % log_every == 0:
                        lf = float(ls[-1])
                        tstate.loss = lf
                        obs["loss"].set(lf)
                        if self._tb_writer is not None:
                            self._tb_writer.add_scalar("Loss", lf,
                                                       self.global_step)
                    for i, loss in enumerate(ls):
                        for fn in self._listeners:
                            fn(step0 + i + 1, loss)
                    if (self._ckpt_trigger is not None
                            and self._ckpt_trigger(tstate)):
                        self.save_checkpoint()
                    guard = self._guard
                    if guard is not None and guard.fired is not None:
                        # preemption: synchronous snapshot first, then exit
                        self.save_checkpoint(wait=True)
                        if guard.fired == signal.SIGINT:
                            raise KeyboardInterrupt
                        raise SystemExit(128 + guard.fired)
                    if end_trigger is not None and end_trigger(tstate):
                        break
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # failure-retry with checkpoint restore
                # (Topology.scala:1180-1262): the backoff between attempts
                # comes from the shared RetryPolicy; the restore copies
                # into the live tensors, so captured graphs stay valid
                if retries_left > 0 and self._ckpt_mgr is not None \
                        and self._ckpt_mgr.latest_step() is not None:
                    attempt = conf.failure_retry_times - retries_left
                    retries_left -= 1
                    logger.warning(
                        "training step failed (%s: %s); restoring latest "
                        "checkpoint and retrying (%d retries left)",
                        type(e).__name__, e, retries_left)
                    RetryPolicy(max_retries=conf.failure_retry_times,
                                base_delay_s=conf.failure_retry_backoff_s
                                ).sleep(attempt)
                    self.maybe_restore_checkpoint()
                    continue
                raise
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
            if self._tb_writer is not None:
                self._write_epoch_summaries(mean_loss, throughput,
                                            obs["step_time"])
            msg = (f"Epoch {self.epoch} ({epoch}/{epochs}) - loss "
                   f"{mean_loss:.4f} - {throughput:.0f} samples/s")
            if validation_data is not None:
                val = self.evaluate(*self._val_tuple(validation_data),
                                    batch_size=batch_size)
                self.model.train()
                for key, v in val.items():
                    hist.append("val_" + key, v)
                    if self._tb_val_writer is not None:
                        self._tb_val_writer.add_scalar(key, v,
                                                       self.global_step)
                tstate.score = next(iter(val.values())) if val else None
                msg += " - " + " ".join(f"val_{key} {v:.4f}"
                                        for key, v in val.items())
            if self._ckpt_trigger is not None and self._ckpt_trigger(tstate):
                self.save_checkpoint()
            if verbose:
                print(msg)
            if end_trigger is not None and end_trigger(tstate):
                break
        for w in (self._tb_writer, self._tb_val_writer):
            if w is not None:
                w.flush()
        return hist

    def _write_epoch_summaries(self, mean_loss, throughput, step_time):
        """Loss, Throughput, and the registry's step-time histogram
        mirrored into the event file (its bucket bounds, read back with
        ``tbwriter.read_histograms``)."""
        w = self._tb_writer
        w.add_scalar("Loss", mean_loss, self.global_step)
        w.add_scalar("Throughput", throughput, self.global_step)
        recent = step_time.recent()
        if recent:
            w.add_histogram("StepTime_s", recent, self.global_step,
                            bucket_limits=step_time.buckets)
            w.add_scalar("StepTime_ms_mean", 1e3 * sum(recent) / len(recent),
                         self.global_step)

    @staticmethod
    def _grouped(batch_iter, k: int):
        """Lists of k consecutive (x, y, w) batches; a final short group
        at its own size (the JAX ``_grouped``, whose ``_stack_group``
        stacks them for ``lax.scan``)."""
        buf = []
        for item in batch_iter:
            buf.append(item)
            if len(buf) == k:
                yield buf
                buf = []
        if buf:
            yield buf

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
        feed_bs = self._feed_batch(batch_size)
        target = self._global_batches(data.size(), feed_bs)
        feed = _DevicePrefetcher(self._sync_batch_count(
            data.batches(feed_bs, pad_final=True), feed_bs, target),
            self._transfer, _INFEED_DEPTH)
        try:
            for sx, sy, sw, _, total in feed:
                self._seq_total = total
                y_pred = self._forward(sx)
                accs = [m.update(acc, y_pred, sy, sw)
                        for m, acc in zip(self.metrics, accs)]
                if self.loss is not None:
                    loss_sum = loss_sum + self._loss_sum(y_pred, sy, sw)
                w_sum = w_sum + sw.sum()
        finally:
            feed.close()
        if self._reduce_axes:
            # global sums: the loss and per-token counts over data and
            # (for sharded tokens) seq, the weights over data
            from analytics_zoo_tpu_torch.parallel import comm
            mesh = self.ctx.mesh
            axes = self._reduce_axes if self._seq_total is not None \
                else [a for a in self._reduce_axes if a == DATA_AXIS]
            comm.all_reduce_(loss_sum, axes, mesh)
            comm.all_reduce_(w_sum, [a for a in axes if a == DATA_AXIS],
                             mesh)
            for acc in accs:
                for v in acc.values():
                    comm.all_reduce_(v, axes, mesh)
        self._seq_total = None
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

        feed_bs = self._feed_batch(batch_size)
        target = self._global_batches(data.size(), feed_bs)
        feed = _DevicePrefetcher(self._sync_batch_count(
            data.batches(feed_bs, pad_final=True), feed_bs, target),
            lambda b: self._transfer(b)[::4] + (int(b[2].shape[0]),),
            _INFEED_DEPTH)
        pending = None  # one-batch-lag readback: batch k's host copy
        try:            # waits behind batch k+1's device work
            for sx, total, nb in feed:
                self._seq_total = total
                yb = self._forward(sx)
                if total is not None:       # the tokens back whole
                    from analytics_zoo_tpu_torch.parallel import comm
                    yb = comm.all_gather(yb, SEQ_AXIS, 1, self.ctx.mesh)
                if pending is not None:
                    readback(*pending)
                pending = (yb, nb)
        finally:
            feed.close()
            self._seq_total = None
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
