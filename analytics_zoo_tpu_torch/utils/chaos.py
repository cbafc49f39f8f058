"""Deterministic fault injection: a copy of the JAX package's
``utils/chaos.py``.

The reference never *tested* its failure story — ``bigdl.failure.retryTimes``
was exercised only by real cluster deaths.  ``FaultInjector`` makes every
resilience path a unit test: failures are scheduled **by site and call
index** (or by predicate on the call's context), so "fail the 3rd queue
write", "raise in preprocess for record r7", and "raise inside training
step 5" are all deterministic, sleep-free assertions.  (The serving
engine's fault points are another class, ``serving/faults.py``.)

Usage:

    inj = FaultInjector()
    inj.fail("put_result", times=3)             # next 3 calls raise
    inj.fail_at("preprocess", indices=[4])      # only the 5th call raises
    inj.fail_when("predict",
                  lambda ctx: (ctx["batch"][:, 0] == 999).any())

    queue.put_result = inj.wrap("put_result", queue.put_result)
    ...
    assert inj.count("put_result") == 7
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Iterable, List, Optional, Type


class InjectedFault(RuntimeError):
    """The exception FaultInjector raises by default; resilience code must
    treat it like any other crash (no special-casing the chaos harness)."""


class _Plan:
    def __init__(self, times: int = 0, indices: Optional[Iterable[int]] = None,
                 when: Optional[Callable[[Dict], bool]] = None,
                 exc: Type[BaseException] = InjectedFault,
                 message: str = ""):
        self.remaining = int(times)
        self.indices = set(int(i) for i in indices) if indices else set()
        self.when = when
        self.exc = exc
        self.message = message

    def should_fire(self, index: int, ctx: Dict) -> bool:
        if self.when is not None:
            return bool(self.when(ctx))
        if self.indices:
            return index in self.indices
        if self.remaining > 0:
            self.remaining -= 1
            return True
        return False


class FaultInjector:
    """Per-site call counters + failure schedules.  Thread-safe: serving
    workers hit sites concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._plans: Dict[str, List[_Plan]] = {}
        self.fired: List[str] = []          # "<site>#<index>" audit trail

    # -- scheduling ---------------------------------------------------------
    def fail(self, site: str, times: int = 1,
             exc: Type[BaseException] = InjectedFault,
             message: str = "") -> "FaultInjector":
        """Fail the next ``times`` calls at ``site``."""
        with self._lock:
            self._plans.setdefault(site, []).append(
                _Plan(times=times, exc=exc, message=message))
        return self

    def fail_at(self, site: str, indices: Iterable[int],
                exc: Type[BaseException] = InjectedFault,
                message: str = "") -> "FaultInjector":
        """Fail calls whose 0-based per-site index is in ``indices``."""
        with self._lock:
            self._plans.setdefault(site, []).append(
                _Plan(indices=indices, exc=exc, message=message))
        return self

    def fail_when(self, site: str, when: Callable[[Dict], bool],
                  exc: Type[BaseException] = InjectedFault,
                  message: str = "") -> "FaultInjector":
        """Fail calls whose context dict satisfies ``when`` (e.g. a poison
        record id or batch content)."""
        with self._lock:
            self._plans.setdefault(site, []).append(
                _Plan(when=when, exc=exc, message=message))
        return self

    @contextlib.contextmanager
    def outage(self, *sites: str, exc: Type[BaseException] = InjectedFault,
               message: str = ""):
        """Hard outage window (availability scenarios): EVERY call at
        the given sites fails while the ``with`` block is active — "kill
        Redis mid-stream" is ``with inj.outage("read_batch", "put_result",
        "get_result"): ...``; on exit the backend "comes back" and half-open
        breaker probes can heal."""
        active = {"on": True}
        added = []
        with self._lock:
            for site in sites:
                plan = _Plan(when=lambda ctx, a=active: a["on"], exc=exc,
                             message=message or f"outage at {site}")
                self._plans.setdefault(site, []).append(plan)
                added.append((site, plan))
        try:
            yield self
        finally:
            active["on"] = False
            # remove (not just disarm) the plans: repeated outage windows
            # must not accumulate dead predicates on the site lists
            with self._lock:
                for site, plan in added:
                    try:
                        self._plans.get(site, []).remove(plan)
                    except ValueError:
                        pass

    def reset(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._counts.clear()
                self._plans.clear()
                self.fired = []
            else:
                self._counts.pop(site, None)
                self._plans.pop(site, None)

    # -- firing -------------------------------------------------------------
    def maybe_fail(self, site: str, **ctx) -> None:
        """Record one call at ``site``; raise if a schedule says so.  The
        keyword context is handed to ``fail_when`` predicates."""
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            plan = None
            for p in self._plans.get(site, []):
                if p.should_fire(index, ctx):
                    plan = p
                    break
            if plan is not None:
                self.fired.append(f"{site}#{index}")
        if plan is not None:
            raise plan.exc(plan.message
                           or f"injected fault at {site}#{index}")

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def wrap(self, site: str, fn: Callable, **static_ctx) -> Callable:
        """Wrap ``fn`` so each call first passes through ``maybe_fail`` with
        the call's positional args exposed as ``args`` in the predicate
        context."""

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.maybe_fail(site, args=args, kwargs=kwargs, **static_ctx)
            return fn(*args, **kwargs)

        return wrapper
