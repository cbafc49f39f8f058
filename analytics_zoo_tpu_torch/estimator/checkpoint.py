"""Training checkpoints: the JAX package's ``estimator/checkpoint.py``
interface over the port's own file format.

Reference parity: BigDL snapshot files written on a trigger
(KerasNet.setCheckpoint Topology.scala:247-257) and reloaded by the
failure-retry loop (Topology.scala:1229-1251).  The JAX package writes one
orbax save of {params, opt_state, model_state, global_step} a fire; the
port writes the same tree (plus ``extra``) with ``torch.save`` of host
tensors, one directory a step:

    <directory>/<step>/state.pt

- ``save`` copies every tensor to the host before it returns (the
  training loop goes on updating the device tensors in place), then
  writes the file on a background thread unless ``wait=True``; one save
  is in flight at a time.
- A step's directory is written under a temporary name and published
  with ``os.replace``, so a process killed mid-save leaves every earlier
  snapshot whole and no partial one under a step's name.
- The ``keep`` newest steps stay; older ones are removed after a
  publish.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

_STATE = "state.pt"


def to_host(tree):
    """``tree`` with every tensor copied to the host (a new tensor even
    for one already there); lists, tuples, dicts and numbers kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def copy_into(dst, src, path: str = ""):
    """Copy ``src``'s tensors into ``dst``'s tensors in place (any
    device), checking that the two trees have one structure and shapes;
    returns ``dst`` with its non-tensor leaves replaced by ``src``'s."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"checkpoint leaf {path or '/'}: "
                             f"{getattr(src, 'shape', type(src))} does not "
                             f"fit {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"checkpoint node {path or '/'}: keys "
                             f"{sorted(src) if isinstance(src, dict) else src}"
                             f" != {sorted(dst)}")
        for k in dst:
            dst[k] = copy_into(dst[k], src[k], f"{path}/{k}")
        return dst
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"checkpoint node {path or '/'}: a sequence "
                             f"of {len(dst)} expected")
        out = [copy_into(d, s, f"{path}/{i}")
               for i, (d, s) in enumerate(zip(dst, src))]
        if isinstance(dst, list):
            dst[:] = out
            return dst
        return type(dst)(out)
    return src


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._serial = 0

    def save(self, step: int, params, opt_state, model_state,
             extra: Optional[Dict[str, Any]] = None,
             wait: bool = False) -> None:
        """Copy the state to the host now; commit it to disk on a
        background thread (``wait=False``, the trigger's save) or before
        returning (``wait=True``: preemption snapshots, final saves)."""
        tree = to_host({"params": params, "opt_state": opt_state,
                        "model_state": model_state,
                        "global_step": int(step)})
        if extra:
            tree["extra"] = to_host(extra)
        self.wait()
        self._serial += 1
        self._thread = threading.Thread(
            target=self._commit, args=(int(step), tree, self._serial),
            name="zoo-checkpoint", daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def _commit(self, step: int, tree: Dict, serial: int) -> None:
        try:
            tmp = os.path.join(self.directory,
                               f".tmp-{step}-{os.getpid()}-{serial}")
            os.makedirs(tmp, exist_ok=True)
            path = os.path.join(tmp, _STATE)
            with open(path, "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, str(step))
            old = None
            if os.path.exists(final):      # the same step saved again
                old = os.path.join(self.directory,
                                   f".old-{step}-{os.getpid()}-{serial}")
                os.replace(final, old)
            os.replace(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            for s in self.steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(s)),
                              ignore_errors=True)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def steps(self):
        """The published steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _STATE)))

    def latest_step(self) -> Optional[int]:
        self.wait()   # surface in-flight saves
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like=None, step: Optional[int] = None):
        """The tree saved at ``step`` (default: the latest), as host
        tensors; with ``like`` (a tree of the same structure) the saved
        tensors are copied into ``like``'s in place, and ``like`` is
        returned with its numbers replaced by the saved ones."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree = torch.load(os.path.join(self.directory, str(step), _STATE),
                          map_location="cpu", weights_only=True)
        if like is None:
            return tree
        return copy_into(like, tree)

    def wait(self):
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()
