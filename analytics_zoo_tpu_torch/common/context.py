"""Runtime/context bootstrap — the PyTorch analog of NNContext.

The JAX package's context discovers devices and lays them out in a mesh;
this one resolves ONE torch device and holds the process-wide seed.  The
device rule every entry point of the port follows lives here
(``resolve_device``): no device given means ``cuda:0``, and with no CUDA
present that is an error — the port never carries on quietly on the CPU.
A caller that wants the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The port's device rule: ``None`` -> ``cuda:0``, raising when CUDA is
    absent; anything else is taken as given (``"cpu"``, ``"cuda:1"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


@dataclasses.dataclass
class ZooConf:
    """Typed config: the seed and the device.  Overridable from environment
    variables prefixed ``ZOO_TPU_`` (``ZOO_TPU_SEED=7``,
    ``ZOO_TPU_DEVICE=cpu``)."""

    seed: int = 42
    device: Optional[str] = None
    # a trace of the whole fit; not ported (the Estimator raises)
    profile_dir: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "ZooConf":
        conf = cls(**overrides)
        if "seed" not in overrides and "ZOO_TPU_SEED" in os.environ:
            conf.seed = int(os.environ["ZOO_TPU_SEED"])
        if "device" not in overrides and os.environ.get("ZOO_TPU_DEVICE"):
            conf.device = os.environ["ZOO_TPU_DEVICE"]
        return conf


class ZooContext:
    """Process-wide runtime context: device and seeded generator."""

    def __init__(self, conf: Optional[ZooConf] = None):
        self.conf = conf or ZooConf.from_env()
        self.device = resolve_device(self.conf.device)
        self._lock = threading.Lock()
        self._gen = torch.Generator().manual_seed(self.conf.seed)

    def next_seed(self) -> int:
        """A fresh seed drawn from the context generator (host side), for
        callers that build their own ``torch.Generator``."""
        with self._lock:
            return int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._gen).item())

    def set_seed(self, seed: int) -> None:
        with self._lock:
            self.conf.seed = seed
            self._gen = torch.Generator().manual_seed(seed)


_global_ctx: Optional[ZooContext] = None
_ctx_lock = threading.Lock()


def init_context(conf: Optional[ZooConf] = None, *, device: DeviceLike = None,
                 seed: Optional[int] = None) -> ZooContext:
    """Initialise (or re-initialise) the global ZooContext."""
    global _global_ctx
    conf = conf or ZooConf.from_env()
    if device is not None:
        conf.device = str(device)
    if seed is not None:
        conf.seed = seed
    with _ctx_lock:
        _global_ctx = ZooContext(conf)
        return _global_ctx



def get_context() -> ZooContext:
    global _global_ctx
    with _ctx_lock:
        if _global_ctx is None:
            _global_ctx = ZooContext()
        return _global_ctx
