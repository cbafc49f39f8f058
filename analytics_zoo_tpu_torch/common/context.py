"""Runtime/context bootstrap — the PyTorch analog of NNContext.

The JAX package's context discovers devices and lays them out in a mesh.
The port runs one process per GPU: its context resolves THIS process's
torch device, the ``torch.distributed`` world the processes form, and a
``Mesh`` over their ranks carrying the JAX axis names.

- The device rule every entry point of the port follows lives here
  (``resolve_device``): no device given means ``cuda:0`` (``cuda:<local
  rank>`` in a world started by ``torchrun``), and with no CUDA present
  that is an error — the port never carries on quietly on the CPU.  A
  caller that wants the CPU (the tests) says ``device="cpu"``.
- The world is built from ``ZooConf.coordinator_address``,
  ``num_processes`` and ``process_id`` (the JAX ``_ensure_distributed``),
  from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``), or adopted where the caller initialised
  ``torch.distributed`` itself.  Its backend is ``nccl`` for a CUDA device
  and ``gloo`` for the CPU, unless the caller names one (``backend=``);
  nothing swaps it afterwards.
- The mesh lays the JAX axes (``data`` … ``expert``) over the ranks in
  process-major (row-major) order, ``-1`` taking the ranks left, and
  gives each axis of more than one rank its own process subgroup
  (``torch.distributed.new_group``; every rank of the world builds the
  same meshes in the same order, as ``new_group`` requires).  A world of
  one still hands the ``data`` axis the world's group, so the gradient
  all-reduce of a fit is launched there too.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

# the JAX package's mesh axis names (data parallelism is always present;
# the other axes are size 1 unless asked for)
DATA_AXIS = "data"
MODEL_AXIS = "model"      # tensor parallelism
PIPE_AXIS = "pipe"        # pipeline parallelism
SEQ_AXIS = "seq"          # sequence/context parallelism
EXPERT_AXIS = "expert"    # expert parallelism (MoE)

ALL_AXES = (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, EXPERT_AXIS)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one mesh axis name (or None) per
    dimension of an array; trailing dimensions not named are
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _world() -> Tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` world,
    or (0, 1) with none."""
    if torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return (torch.distributed.get_rank(),
                torch.distributed.get_world_size())
    return 0, 1


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The port's device rule: ``None`` -> ``cuda:0`` (``cuda:<LOCAL_RANK>``
    when ``torchrun`` set it), raising when CUDA is absent; anything else
    is taken as given (``"cpu"``, ``"cuda:1"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


# process subgroups by (world, ranks): every mesh over the same ranks
# shares them, so building a context again creates no group
_GROUPS: Dict[tuple, object] = {}


def _group(ranks: Tuple[int, ...]):
    # keyed by the world's group object itself (held, so that a later
    # world never takes its id)
    key = (torch.distributed.group.WORLD, ranks)
    if key not in _GROUPS:
        _GROUPS[key] = torch.distributed.new_group(list(ranks))
    return _GROUPS[key]


class Mesh:
    """The ranks of a world laid out over named axes.

    ``shape`` maps each axis name to its size, in order; ``devices`` is
    the (axis sizes) array of ranks; ``index(axis)`` is this rank's
    coordinate on an axis, ``size(axis)`` the axis's size (1 for an axis
    the mesh has not got), ``ranks(axis)`` the ranks of this rank's line
    along it (in axis order) and ``group(axis)`` their process group (None
    where no collective runs: a line of one rank outside a world of one,
    or a rank outside the mesh)."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int],
                 ranks: Sequence[int], rank: int):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(self.shape.values()) or (1,))
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        self.coords = ({a: int(c) for a, c in zip(self.axis_names,
                                                  where[0])}
                       if len(where) else None)
        self._lines: Dict[str, Tuple[int, ...]] = {}
        self._groups: Dict[str, object] = {}
        _, world = _world()
        initialised = torch.distributed.is_available() \
            and torch.distributed.is_initialized()
        if not initialised:
            return
        # every rank creates every line's group, in one order
        for ax_i, ax in enumerate(self.axis_names):
            n = self.shape[ax]
            if n == 1 and world == 1:
                self._groups[ax] = torch.distributed.group.WORLD
                self._lines[ax] = (self.rank,)
                continue
            if n == 1:
                continue
            moved = np.moveaxis(self.devices, ax_i, -1).reshape(-1, n)
            for line in moved:
                line = tuple(int(r) for r in line)
                g = _group(line)
                if self.rank in line:
                    self._groups[ax] = g
                    self._lines[ax] = line

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        if self.coords is None or axis not in self.coords:
            return 0
        return self.coords[axis]

    def ranks(self, axis: str) -> Tuple[int, ...]:
        return self._lines.get(axis, (self.rank,))

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


@dataclasses.dataclass
class ZooConf:
    """Typed config: the seed, the device, the mesh, the world and the
    training loop's settings.  Overridable from environment variables
    prefixed ``ZOO_TPU_`` (``ZOO_TPU_SEED=7``, ``ZOO_TPU_DEVICE=cpu``,
    ``ZOO_TPU_MESH_AXES=data,model``, ``ZOO_TPU_MESH_SHAPE=-1,2``)."""

    seed: int = 42
    device: Optional[str] = None
    # mesh layout: axis name -> size; -1 takes the ranks left
    mesh_axes: Tuple[str, ...] = (DATA_AXIS,)
    mesh_shape: Tuple[int, ...] = (-1,)
    # fit()'s failure-retry loop: restores of the latest checkpoint after
    # a failed step (bigdl.failure.retryTimes), the backoff base between
    # them (common/resilience.RetryPolicy), and the snapshots kept
    failure_retry_times: int = 5
    failure_retry_backoff_s: float = 0.1
    checkpoint_keep: int = 3
    # a torch.profiler trace of each whole fit is written here when set
    profile_dir: str = ""
    # the multi-process world: a non-empty coordinator address
    # ("host:port", or an init_method URL such as "file:///path")
    # initialises torch.distributed with num_processes and process_id
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1
    # the world's backend: "" is nccl for a CUDA device, gloo for the CPU
    backend: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "ZooConf":
        conf = cls(**overrides)
        env = os.environ
        for f in dataclasses.fields(conf):
            key = "ZOO_TPU_" + f.name.upper()
            if f.name in overrides or not env.get(key):
                continue
            raw, default = env[key], f.default
            if f.name == "device":
                conf.device = raw
            elif isinstance(default, tuple):
                parts = [p.strip() for p in raw.split(",") if p.strip()]
                if default and isinstance(default[0], int):
                    parts = [int(p) for p in parts]
                setattr(conf, f.name, tuple(parts))
            elif isinstance(default, (int, float, str)):
                setattr(conf, f.name, type(default)(raw))
        return conf


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _ensure_distributed(conf: ZooConf, device: torch.device) -> None:
    """Initialise ``torch.distributed`` once: from the coordinator fields,
    or from ``torchrun``'s environment; with neither, no world.  A world
    the caller initialised is adopted as it is."""
    if not torch.distributed.is_available() \
            or torch.distributed.is_initialized():
        return
    env = os.environ
    backend = conf.backend or default_backend(device)
    if conf.coordinator_address:
        addr = conf.coordinator_address
        method = addr if "://" in addr else f"tcp://{addr}"
        if conf.num_processes < 1 or conf.process_id < 0:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        torch.distributed.init_process_group(
            backend, init_method=method, world_size=conf.num_processes,
            rank=conf.process_id)
    elif env.get("WORLD_SIZE") and env.get("RANK") \
            and env.get("MASTER_ADDR"):
        torch.distributed.init_process_group(backend, init_method="env://")


class ZooContext:
    """Process-wide runtime context: device, world, mesh and seeded
    generator.

    ``devices`` are the ranks the mesh spans (default: the whole world);
    ``devices=[rank]`` makes a process-local context, whose trials run
    no collective (``automl.search.MultiProcessSearchEngine``)."""

    def __init__(self, conf: Optional[ZooConf] = None,
                 devices: Optional[Sequence[int]] = None):
        self.conf = conf or ZooConf.from_env()
        self.device = resolve_device(self.conf.device)
        _ensure_distributed(self.conf, self.device)
        rank, world = _world()
        self.devices: List[int] = (list(range(world)) if devices is None
                                   else [int(d) for d in devices])
        self.mesh = self._build_mesh(rank)
        self._lock = threading.Lock()
        self._gen = torch.Generator().manual_seed(self.conf.seed)

    # -- mesh -----------------------------------------------------------------
    def _build_mesh(self, rank: int) -> Mesh:
        axes = list(self.conf.mesh_axes)
        shape = [int(s) for s in self.conf.mesh_shape]
        if len(axes) != len(shape):
            raise ValueError(f"mesh_axes {axes} and mesh_shape {shape} "
                             "differ in length")
        n = len(self.devices)
        fixed = math.prod(s for s in shape if s > 0)
        if -1 in shape:
            if n % fixed:
                raise ValueError(f"{n} ranks not divisible by the fixed "
                                 f"mesh dims {fixed}")
            shape[shape.index(-1)] = n // fixed
        used = math.prod(shape)
        if used != n:
            raise ValueError(f"mesh shape {shape} needs {used} ranks, the "
                             f"context spans {n}")
        return Mesh(axes, shape, self.devices, rank)

    @property
    def num_devices(self) -> int:
        return int(self.mesh.devices.size)

    @property
    def data_parallel_size(self) -> int:
        return self.mesh.size(DATA_AXIS)

    # -- multi-process topology -----------------------------------------------
    @property
    def process_count(self) -> int:
        """Processes in THIS context's mesh (one a GPU), not the world's:
        a process-local context is single-process for the Estimator."""
        return self.num_devices

    @property
    def process_index(self) -> int:
        return _world()[0]

    @property
    def is_multi_host(self) -> bool:
        return self.process_count > 1

    def local_devices(self) -> List[torch.device]:
        return [self.device]

    # -- sharding helpers -----------------------------------------------------
    def data_sharding(self, batch_rank: int = 1) -> PartitionSpec:
        """The spec that splits the leading (batch) axis over ``data``."""
        return P(DATA_AXIS, *([None] * (batch_rank - 1)))

    def replicated_sharding(self) -> PartitionSpec:
        return P()

    def batch_sharding_for(self, shape, token_len: Optional[int] = None
                           ) -> PartitionSpec:
        """One batch array's spec: the leading axis over ``data``, and the
        second (token) axis over ``seq`` when the mesh has a seq axis > 1
        and axis 1 IS the token axis: ``token_len`` (the model input's
        axis-1 length) must match it and divide evenly.  A (B, C) one-hot
        label whose C merely divides the seq axis stays data-sharded."""
        rank = len(shape)
        axes = [DATA_AXIS] + [None] * (rank - 1)
        n_seq = self.mesh.size(SEQ_AXIS)
        if (rank >= 2 and n_seq > 1 and token_len is not None
                and shape[1] == token_len and shape[1] % n_seq == 0
                and shape[1] > 1):
            axes[1] = SEQ_AXIS
        return P(*axes)

    def global_device_put(self, tree, spec: PartitionSpec):
        """This rank's shard of a host-local tree (every rank holds the same
        host value), on the context's device (``global_put``)."""
        if isinstance(tree, dict):
            return {k: self.global_device_put(v, spec)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self.global_device_put(v, spec) for v in tree]
        return global_put(tree, spec, self.mesh).to(self.device)

    # -- rng ------------------------------------------------------------------
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


def shard_slice(n: int, parts: int, index: int, groups: int = 1
                ) -> torch.Tensor:
    """Indices of part ``index`` of ``parts`` along a dimension of ``n``
    viewed as ``groups`` equal runs (each run split alike: a fused qkv's
    q, k and v columns)."""
    if n % (groups * parts):
        raise ValueError(f"dimension {n} does not split into {groups} "
                         f"run(s) of {parts} parts")
    run, part = n // groups, n // (groups * parts)
    return torch.cat([torch.arange(g * run + index * part,
                                   g * run + (index + 1) * part)
                      for g in range(groups)])


def global_put(leaf, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a host value every rank holds alike (the JAX
    ``global_put``: each process fills only its own shards): dimension d
    split over ``spec[d]``'s axis, contiguously, at this rank's index."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    for d, ax in enumerate(tuple(spec)[:t.ndim]):
        if ax is None or mesh.size(ax) == 1:
            continue
        n = mesh.size(ax)
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"split over {ax!r} ({n})")
        part = t.shape[d] // n
        t = t.narrow(d, mesh.index(ax) * part, part)
    return t


_global_ctx: Optional[ZooContext] = None
_ctx_lock = threading.Lock()


def init_context(conf: Optional[ZooConf] = None, *, mesh_axes=None,
                 mesh_shape=None, devices=None, device: DeviceLike = None,
                 backend: Optional[str] = None,
                 seed: Optional[int] = None) -> ZooContext:
    """Initialise (or re-initialise) the global ZooContext (the JAX
    ``init_context``; ``init_nncontext`` is its alias).  ``devices``: the
    ranks the mesh spans; ``device``: this process's torch device;
    ``backend``: the world's, where this call initialises it."""
    global _global_ctx
    conf = conf or ZooConf.from_env()
    if mesh_axes is not None:
        conf.mesh_axes = tuple(mesh_axes)
    if mesh_shape is not None:
        conf.mesh_shape = tuple(mesh_shape)
    if device is not None:
        conf.device = str(device)
    if backend is not None:
        conf.backend = backend
    if seed is not None:
        conf.seed = seed
    with _ctx_lock:
        _global_ctx = ZooContext(conf, devices=devices)
        return _global_ctx


# API-parity alias (pyzoo/zoo/common/nncontext.py:23)
init_nncontext = init_context


def get_context() -> ZooContext:
    global _global_ctx
    with _ctx_lock:
        if _global_ctx is None:
            _global_ctx = ZooContext()
        return _global_ctx


def mesh() -> Mesh:
    return get_context().mesh
