"""AutoML search engine and hyperparameter space — the JAX package's
``automl/search.py``, which is numpy only, so this is a copy: the same
seed and space give the same configs in both packages.

Reference parity: ``SearchEngine`` (automl/search/abstract.py:1-66) with
the RayTuneSearchEngine implementation (search/RayTuneSearchEngine.py:
28-224: ``tune.run`` over a sample-space dict, optional Bayesian search).
The engines are native: sequential (or thread-pooled) trials over
sampled configs.  Space primitives mirror automl/config/recipe.py usage
(tune.uniform/qrandint/choice...).

``MultiProcessSearchEngine`` dispatches trials over the processes of a
``torch.distributed`` world (the JAX one over ``jax.distributed``'s);
like the JAX ``automl/__init__.py``, the package does not export it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# -- search space primitives ---------------------------------------------------

class Sampler:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def grid(self) -> List:
        raise NotImplementedError("no finite grid for this sampler")


@dataclasses.dataclass
class Uniform(Sampler):
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclasses.dataclass
class LogUniform(Sampler):
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclasses.dataclass
class RandInt(Sampler):
    low: int
    high: int

    def sample(self, rng):
        return int(rng.integers(self.low, self.high + 1))


@dataclasses.dataclass
class QUniform(Sampler):
    low: float
    high: float
    q: float = 1.0

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return float(np.round(v / self.q) * self.q)


@dataclasses.dataclass
class Choice(Sampler):
    options: Sequence

    def sample(self, rng):
        return self.options[int(rng.integers(0, len(self.options)))]

    def grid(self):
        return list(self.options)


class GridSearch(Choice):
    """A Choice that grid engines expand exhaustively instead of sampling
    (recipe.py GridSearch parity)."""


class SampleFn(Sampler):
    """Config-dependent sampler: fn(config_so_far, rng) -> value — the
    RandomSample(lambda spec: ...) analog, incl. dependent params like
    MTNet's past_seq_len = (long_num + 1) * time_step
    (recipe.py:339-341)."""

    def __init__(self, fn: Callable[[Dict, np.random.Generator], Any]):
        self.fn = fn

    def sample(self, rng, config: Optional[Dict] = None):
        return self.fn(config or {}, rng)


def sample_config(space: Dict[str, Any], rng: np.random.Generator) -> Dict:
    """Two passes: independent samplers first, then SampleFn entries (which
    may read previously-sampled values)."""
    out = {}
    deferred = []
    for k, v in space.items():
        if isinstance(v, SampleFn):
            deferred.append(k)
        elif isinstance(v, Sampler):
            out[k] = v.sample(rng)
        else:
            out[k] = v
    for k in deferred:
        out[k] = space[k].sample(rng, out)
    return out


# -- engines -------------------------------------------------------------------

@dataclasses.dataclass
class Trial:
    config: Dict
    metric: float
    extra: Optional[Dict] = None
    # crash marker (ADVICE r5): a trial whose train_fn RAISED is scored ±inf
    # so best-trial selection still works, but downstream consumers
    # (predictor._last_trials, reports) can tell a crashed trial from a
    # legitimately bad config.  `error` carries the exception text on the
    # process that ran the trial (other processes only see the flag).
    failed: bool = False
    error: Optional[str] = None


class SearchEngine:
    """abstract.py parity: compile(space) -> run() -> get_best_config()."""

    def __init__(self, mode: str = "min"):
        assert mode in ("min", "max")
        self.mode = mode
        self.trials: List[Trial] = []

    def run(self, train_fn: Callable[[Dict], float], space: Dict) -> List[Trial]:
        raise NotImplementedError

    def get_best_trial(self) -> Trial:
        if not self.trials:
            raise RuntimeError("no trials have run")
        key = (min if self.mode == "min" else max)
        return key(self.trials, key=lambda t: t.metric)

    def get_best_config(self) -> Dict:
        return self.get_best_trial().config


class RandomSearchEngine(SearchEngine):
    def __init__(self, n_trials: int = 10, mode: str = "min", seed: int = 0,
                 parallelism: int = 1):
        super().__init__(mode)
        self.n_trials = n_trials
        self.seed = seed
        self.parallelism = parallelism

    def sample_all(self, space: Dict) -> List[Dict]:
        rng = np.random.default_rng(self.seed)
        return [sample_config(space, rng) for _ in range(self.n_trials)]

    def run(self, train_fn, space):
        configs = self.sample_all(space)
        if self.parallelism > 1:
            with ThreadPoolExecutor(self.parallelism) as pool:
                metrics = list(pool.map(train_fn, configs))
        else:
            metrics = [train_fn(c) for c in configs]
        self.trials = [Trial(c, float(m)) for c, m in zip(configs, metrics)]
        return self.trials


class GridSearchEngine(SearchEngine):
    """Cartesian product over Choice dims; non-Choice samplers drawn once per point."""

    def __init__(self, mode: str = "min", seed: int = 0):
        super().__init__(mode)
        self.seed = seed

    def run(self, train_fn, space):
        import itertools
        rng = np.random.default_rng(self.seed)
        grid_keys = [k for k, v in space.items()
                     if isinstance(v, Choice)]
        grids = [space[k].grid() for k in grid_keys]
        self.trials = []
        for combo in itertools.product(*grids) if grids else [()]:
            cfg = sample_config(
                {k: v for k, v in space.items() if k not in grid_keys}, rng)
            cfg.update(dict(zip(grid_keys, combo)))
            self.trials.append(Trial(cfg, float(train_fn(cfg))))
        return self.trials


class GridRandomSearchEngine(SearchEngine):
    """Grid dims (GridSearch) expanded exhaustively × num_rand_samples random
    draws of everything else, trials executed CONCURRENTLY on a thread pool
    (the native stand-in for RayTuneSearchEngine.py:133-150 tune.run over a
    cluster: trials share the single accelerator but overlap host-side work —
    unroll, batch prep, eval readback — with device compute)."""

    def __init__(self, num_rand_samples: int = 1, mode: str = "min",
                 seed: int = 0, parallelism: int = 2):
        super().__init__(mode)
        self.num_rand_samples = num_rand_samples
        self.seed = seed
        self.parallelism = max(1, int(parallelism))

    def sample_all(self, space: Dict) -> List[Dict]:
        import itertools
        rng = np.random.default_rng(self.seed)
        grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
        grids = [space[k].grid() for k in grid_keys]
        configs = []
        for combo in (itertools.product(*grids) if grids else [()]):
            for _ in range(self.num_rand_samples):
                cfg = sample_config(
                    {k: v for k, v in space.items() if k not in grid_keys},
                    rng)
                cfg.update(dict(zip(grid_keys, combo)))
                configs.append(cfg)
        return configs

    def run(self, train_fn, space):
        configs = self.sample_all(space)
        if self.parallelism > 1:
            with ThreadPoolExecutor(self.parallelism) as pool:
                metrics = list(pool.map(train_fn, configs))
        else:
            metrics = [train_fn(c) for c in configs]
        self.trials = [Trial(c, float(m)) for c, m in zip(configs, metrics)]
        return self.trials


class BayesSearchEngine(SearchEngine):
    """Lightweight Bayesian-ish search: random exploration then local perturbation of
    the incumbent (the reference's BayesOpt option without the skopt dep)."""

    def __init__(self, n_trials: int = 20, explore_frac: float = 0.5,
                 mode: str = "min", seed: int = 0):
        super().__init__(mode)
        self.n_trials = n_trials
        self.explore = max(1, int(n_trials * explore_frac))
        self.seed = seed

    def run(self, train_fn, space):
        rng = np.random.default_rng(self.seed)
        self.trials = []
        for i in range(self.n_trials):
            if i < self.explore or not self.trials:
                cfg = sample_config(space, rng)
            else:
                best = self.get_best_trial().config
                cfg = dict(best)
                for k, v in space.items():
                    if isinstance(v, (Uniform, LogUniform, QUniform)) \
                            and rng.random() < 0.5:
                        jitter = 0.8 + 0.4 * rng.random()
                        cfg[k] = float(np.clip(best[k] * jitter, v.low, v.high))
                    elif isinstance(v, (Choice, RandInt)) and rng.random() < 0.3:
                        cfg[k] = v.sample(rng)
            self.trials.append(Trial(cfg, float(train_fn(cfg))))
        return self.trials


class MultiProcessSearchEngine(SearchEngine):
    """Round-robin trial dispatch over the processes of a
    ``torch.distributed`` world (the RayTuneSearchEngine.py:133-150
    cluster ``tune.run`` analog without Ray).

    Every process derives the SAME config list from the wrapped engine's
    ``sample_all(space)`` (shared seed); process p runs trials p, p+N,
    p+2N, ... on its own device, and the per-trial metrics (with each
    trial's crash flag) are exchanged with ONE ``all_gather_object`` at
    the end, the only communication of the search.  ``train_fn`` must be
    process-local: build the training context over this process alone
    (``init_context(devices=[rank])``) so that no trial issues a
    collective.  A world of one runs the wrapped engine's own loop
    (thread-pooled by its own parallelism)."""

    def __init__(self, inner: SearchEngine, mode: Optional[str] = None):
        if not hasattr(inner, "sample_all"):
            raise TypeError(
                f"{type(inner).__name__} cannot pre-enumerate its configs "
                "(no sample_all); use RandomSearchEngine or "
                "GridRandomSearchEngine as the inner engine")
        super().__init__(mode or inner.mode)
        self.inner = inner

    def run(self, train_fn, space):
        import torch.distributed as dist

        from analytics_zoo_tpu_torch.common import context
        pc, pi = 1, 0
        if dist.is_available() and dist.is_initialized():
            pc, pi = dist.get_world_size(), dist.get_rank()
        if pc == 1:
            self.trials = self.inner.run(train_fn, space)
            return self.trials
        ctx = context._global_ctx
        if ctx is not None and ctx.is_multi_host:
            # a context over the world would make every trial a
            # collective program: different configs on different
            # processes then issue mismatched collectives and hang
            raise RuntimeError(
                "MultiProcessSearchEngine needs a PROCESS-LOCAL training "
                "context: call init_context(devices=[rank]) before the "
                f"search (the current context's mesh spans "
                f"{ctx.process_count} processes)")
        configs = self.inner.sample_all(space)
        n = len(configs)
        metrics, failed, errors = self._run_local(configs, train_fn, pi, pc)
        gathered = [None] * pc
        dist.all_gather_object(gathered, (metrics.tolist(),
                                          failed.tolist()))
        # trial i ran on process i % pc
        metrics = np.asarray([gathered[i % pc][0][i] for i in range(n)])
        failed = np.asarray([gathered[i % pc][1][i] for i in range(n)])
        self.trials = [
            Trial(c, float(m), failed=bool(f), error=errors.get(i))
            for i, (c, m, f) in enumerate(zip(configs, metrics, failed))]
        return self.trials

    def _run_local(self, configs, train_fn, pi: int, pc: int):
        """Run this process's slice of the config list.  A crashed trial
        is scored as the worst metric AND flagged, and must not strand
        the other processes in the final gather."""
        n = len(configs)
        worst = math.inf if self.mode == "min" else -math.inf
        metrics = np.full((n,), np.nan, np.float64)
        failed = np.zeros((n,), np.float64)
        errors: Dict[int, str] = {}
        for i in range(pi, n, pc):
            try:
                metrics[i] = float(train_fn(configs[i]))
            except Exception as e:  # noqa: BLE001
                logging.getLogger(__name__).warning(
                    "trial %d failed (%s: %s); scored as %s",
                    i, type(e).__name__, e, worst)
                metrics[i] = worst
                failed[i] = 1.0
                errors[i] = f"{type(e).__name__}: {e}"
        return metrics, failed, errors
