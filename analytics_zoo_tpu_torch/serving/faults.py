"""Deterministic, config-gated fault injection (the JAX package's
``serving/faults.py``).

A ``params.faults`` block arms named fault points inside a live replica,
and every point is gated on the replica's ``model_version``, so a canary
at v2 misbehaves while its v1 incumbents stay healthy.

Config shape (``params.faults`` in config.yaml)::

    faults:
      predict_error:            # do_predict raises (rows quarantine)
        version: v2             # "*" = every version, absent = never
        after: 0                # records served cleanly before failing
      predict_slow:             # do_predict sleeps first
        version: v2
        ms: 250
      warmup_crash:             # process exits mid-warm-up (os._exit): a
        version: v2             # crash, not an exception
      readyz_delay:             # readiness held false after start
        version: v2
        seconds: 10
      claim_stall:              # read loop stalls before claiming
        version: v2
        seconds: 0.5
        count: 10               # stalls injected before the point disarms
      admission_reject:         # admission gate rejects the next N
        version: v2             # requests with reason "fault"
        count: 5
        priority: best_effort   # optional: only this class is rejected
      decode_crash_after_n_tokens:   # process exits (os._exit) once the
        version: "*"                 # generation plane has produced n
        n: 12                        # tokens
        once: /tmp/crash.marker      # optional marker file: created at
                                     # fire, and any process that SEES it
                                     # skips the fault — one crash per
                                     # deployment even under respawn
      snapshot_corrupt:         # generation checkpoints are written with
        version: "*"            # a broken integrity checksum, so a resume
                                # must detect it and restart from 0

Every knob is deterministic: the same config and record sequence produce
the same failures, so tests assert exact outcomes.  The offline
companion ``corrupt_store_leaf`` damages a weight store on disk.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class FaultError(RuntimeError):
    """Raised by an armed ``predict_error`` fault point — the message names
    the fault and version so quarantine markers are attributable."""


def _gate(spec, model_version: Optional[str]) -> Optional[dict]:
    """A fault point's config, iff it is armed for this replica's version.
    ``version: "*"`` arms it everywhere; a missing or empty version
    selector never fires (faults are strictly opt-in)."""
    if not isinstance(spec, dict):
        return None
    sel = spec.get("version")
    if not sel:
        return None
    if sel != "*" and sel != (model_version or ""):
        return None
    return spec


class FaultInjector:
    """The armed fault points of ONE replica (its parsed ``params.faults``
    dict and its ``model_version``).  An inactive injector costs nothing:
    the engine wires a fault point only when it is armed."""

    def __init__(self, faults: Optional[dict],
                 model_version: Optional[str] = None):
        faults = faults if isinstance(faults, dict) else {}
        self.model_version = model_version
        self._predict_error = _gate(faults.get("predict_error"),
                                    model_version)
        self._predict_slow = _gate(faults.get("predict_slow"),
                                   model_version)
        self._warmup_crash = _gate(faults.get("warmup_crash"),
                                   model_version)
        self._readyz_delay = _gate(faults.get("readyz_delay"),
                                   model_version)
        self._claim_stall = _gate(faults.get("claim_stall"),
                                  model_version)
        self._admission_reject = _gate(faults.get("admission_reject"),
                                       model_version)
        self._decode_crash = _gate(
            faults.get("decode_crash_after_n_tokens"), model_version)
        self._snapshot_corrupt = _gate(faults.get("snapshot_corrupt"),
                                       model_version)
        self._predict_calls = 0
        self._claim_stalls_left = int(
            (self._claim_stall or {}).get("count", 1))
        self._admission_rejects_left = int(
            (self._admission_reject or {}).get("count", 1))

    # -- introspection -------------------------------------------------------
    @property
    def predict_active(self) -> bool:
        return (self._predict_error is not None
                or self._predict_slow is not None)

    @property
    def readyz_active(self) -> bool:
        return self._readyz_delay is not None

    @property
    def claim_active(self) -> bool:
        return self._claim_stall is not None

    @property
    def admission_active(self) -> bool:
        return self._admission_reject is not None

    @property
    def decode_crash_active(self) -> bool:
        return self._decode_crash is not None

    @property
    def snapshot_corrupt_active(self) -> bool:
        return self._snapshot_corrupt is not None

    @property
    def any_active(self) -> bool:
        return (self.predict_active or self.readyz_active
                or self.claim_active or self.admission_active
                or self._warmup_crash is not None
                or self.decode_crash_active
                or self.snapshot_corrupt_active)

    def describe(self) -> list:
        """Armed fault-point names (they ride the health document, so an
        armed replica is visible from the outside)."""
        out = []
        if self._predict_error is not None:
            out.append("predict_error")
        if self._predict_slow is not None:
            out.append("predict_slow")
        if self._warmup_crash is not None:
            out.append("warmup_crash")
        if self._readyz_delay is not None:
            out.append("readyz_delay")
        if self._claim_stall is not None:
            out.append("claim_stall")
        if self._admission_reject is not None:
            out.append("admission_reject")
        if self._decode_crash is not None:
            out.append("decode_crash_after_n_tokens")
        if self._snapshot_corrupt is not None:
            out.append("snapshot_corrupt")
        return out

    # -- fault points ---------------------------------------------------------
    def wrap_predict(self, fn: Callable) -> Callable:
        """Wrap ``do_predict``: sleep first when ``predict_slow`` is armed,
        then raise :class:`FaultError` once ``predict_error``'s ``after``
        budget of clean calls is spent.  The engine instance-patches the
        wrapper onto the model, and its dispatch keeps an instance-patched
        ``do_predict`` on the hot path, so the injected failure flows
        through the real quarantine / bisect machinery."""

        def _predict(tensors, scales=None, **kw):
            self._predict_calls += 1
            slow = self._predict_slow
            if slow is not None:
                time.sleep(float(slow.get("ms", 100)) / 1000.0)
            err = self._predict_error
            if err is not None and \
                    self._predict_calls > int(err.get("after", 0)):
                raise FaultError(
                    f"injected predict_error (version "
                    f"{self.model_version or '*'}, call "
                    f"#{self._predict_calls})")
            return fn(tensors, scales=scales, **kw)

        return _predict

    def check_warmup(self) -> None:
        """``warmup_crash``: kill the PROCESS (not an exception — the
        warm-up loop catches those and degrades gracefully; the fault must
        look like a real crash)."""
        if self._warmup_crash is not None:
            logger.error("faults: injected warmup_crash (version %s) — "
                         "exiting", self.model_version)
            os._exit(3)

    def take_claim_stall(self) -> float:
        """``claim_stall``: seconds the read loop should stall before this
        claim, 0.0 when disarmed or the ``count`` budget is spent.  The
        ENGINE sleeps (not this method), so tests can call it without
        waiting."""
        if self._claim_stall is None or self._claim_stalls_left <= 0:
            return 0.0
        self._claim_stalls_left -= 1
        return max(0.0, float(self._claim_stall.get("seconds", 0.5)))

    def take_admission_reject(self, priority: Optional[str] = None) -> bool:
        """``admission_reject``: True when the admission gate must reject
        THIS request (reason "fault").  An optional ``priority`` selector
        restricts the fault to one class; the ``count`` budget makes
        outcomes exact."""
        spec = self._admission_reject
        if spec is None or self._admission_rejects_left <= 0:
            return False
        want = spec.get("priority")
        if want and priority is not None and str(want) != str(priority):
            return False
        self._admission_rejects_left -= 1
        return True

    def take_decode_crash(self, generated_tokens: int) -> bool:
        """``decode_crash_after_n_tokens``: True when the process must die
        NOW — the generation plane has produced at least ``n`` tokens and
        the optional ``once`` marker has not been claimed.  Creating the
        marker BEFORE returning makes the crash exactly-once per
        deployment: a respawn (and every sibling replica) sees the marker
        and skips the fault.  The ENGINE exits (``os._exit``), so tests
        can call this without dying."""
        spec = self._decode_crash
        if spec is None:
            return False
        if generated_tokens < int(spec.get("n", 1)):
            return False
        marker = spec.get("once")
        if marker:
            try:
                # O_CREAT|O_EXCL: atomic claim — two replicas crossing the
                # threshold in the same tick still crash only once
                fd = os.open(str(marker),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return False
            except OSError:
                return False               # unwritable marker: stay safe
        return True

    def readyz_block_reason(self, uptime_s: float) -> Optional[str]:
        """``readyz_delay``: a not-ready reason until ``seconds`` of uptime
        have passed."""
        d = self._readyz_delay
        if d is None:
            return None
        hold = float(d.get("seconds", 10))
        if uptime_s < hold:
            return (f"fault-injected readyz_delay "
                    f"({uptime_s:.1f}/{hold:g}s)")
        return None


def corrupt_store_leaf(store_dir: str, leaf_index: int = 0,
                       truncate_to: int = 0) -> str:
    """Truncate one leaf file of a weight store IN PLACE (the manifest is
    left intact, so only integrity verification — not a directory listing
    — can tell).  Returns the corrupted file's path.  Test helper for the
    "corrupt store leaf" fault: ``registry.verify`` must report it and
    the rollout must refuse the version."""
    import json
    with open(os.path.join(store_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files = sorted({m["file"] for m in manifest["leaves"].values()})
    if not files:
        raise ValueError(f"{store_dir!r}: store has no leaves")
    target = os.path.join(store_dir, files[leaf_index % len(files)])
    with open(target, "r+b") as f:
        f.truncate(truncate_to)
    return target
