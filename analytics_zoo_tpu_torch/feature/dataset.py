"""FeatureSet — the training-data abstraction feeding the device; a copy of
the JAX package's ``feature/dataset.py`` (numpy only).

Data lives on the host as numpy (DRAM tier) or as mmap'd arrays (DISK tier), and an
iterator yields fixed-shape batches that the Estimator copies to the device.  Partial
final batches are padded with zero-weight rows, so eval metrics are exact and the batch
order and padding are the JAX package's for the same shuffle generator.  The
`NativeFeatureSet` (the C++ sample store) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence[np.ndarray]]


class MemoryType:
    DRAM = "DRAM"
    DISK_AND_DRAM = "DISK_AND_DRAM"   # mmap-backed
    PMEM = "PMEM"                      # treated as DISK tier (no Optane on TPU hosts)


def _listify(x) -> List[np.ndarray]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


class FeatureSet:
    """Base: len + batch iterator of (xs, ys, weights)."""

    def size(self) -> int:
        raise NotImplementedError

    def batches(self, batch_size: int, *, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = False,
                pad_final: bool = True) -> Iterator[Tuple]:
        raise NotImplementedError

    # -- constructors (FeatureSet.rdd / .array analogs) ----------------------
    @staticmethod
    def from_arrays(x: ArrayLike, y: Optional[ArrayLike] = None,
                    memory_type: str = MemoryType.DRAM) -> "ArrayFeatureSet":
        return ArrayFeatureSet(x, y, memory_type=memory_type)

    @staticmethod
    def from_iterator(fn: Callable[[], Iterator], size: int) -> "IteratorFeatureSet":
        return IteratorFeatureSet(fn, size)

    @staticmethod
    def from_memmap(paths_x: Sequence[str], shapes_x, dtypes_x,
                    path_y: Optional[str] = None, shape_y=None, dtype_y=None
                    ) -> "ArrayFeatureSet":
        """DISK_AND_DRAM tier: arrays stay on disk, OS pages them in on demand."""
        xs = [np.memmap(p, mode="r", dtype=d, shape=tuple(s))
              for p, s, d in zip(paths_x, shapes_x, dtypes_x)]
        y = (np.memmap(path_y, mode="r", dtype=dtype_y, shape=tuple(shape_y))
             if path_y else None)
        return ArrayFeatureSet(xs, y, memory_type=MemoryType.DISK_AND_DRAM)


class ArrayFeatureSet(FeatureSet):
    def __init__(self, x: ArrayLike, y: Optional[ArrayLike] = None,
                 memory_type: str = MemoryType.DRAM):
        self.xs = _listify(x)
        self.ys = _listify(y)
        self.memory_type = memory_type
        if not self.xs:
            raise ValueError("FeatureSet needs at least one feature array")
        n = self.xs[0].shape[0]
        for a in self.xs + self.ys:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading (sample) dim")
        self._n = n

    def size(self) -> int:
        return self._n

    def batches(self, batch_size: int, *, shuffle=False, rng=None,
                drop_remainder=False, pad_final=True):
        """Yield (xs, ys, weight) batches; a short final batch is padded with
        copies of sample 0 at weight 0 so every batch has a static shape.

        Limitation: the pad rows are weight-masked out of the loss but still
        enter unweighted batch reductions — BatchNormalization training
        statistics see them, slightly biasing stats on the last partial batch.
        Use drop_remainder=True when exact BN statistics matter, and for
        ranking data (rank_hinge assumes an intact [pos, neg] interleave).
        """
        n = self._n
        idx = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            sel = idx[start:start + batch_size]
            w = np.ones((len(sel),), np.float32)
            if len(sel) < batch_size and pad_final:
                pad = batch_size - len(sel)
                sel = np.concatenate([sel, np.zeros((pad,), np.int64)])
                w = np.concatenate([w, np.zeros((pad,), np.float32)])
            xs = [a[sel] for a in self.xs]
            ys = [a[sel] for a in self.ys]
            yield (xs[0] if len(xs) == 1 else xs,
                   (ys[0] if len(ys) == 1 else ys) if ys else None,
                   w)

    def partition(self, index: int, count: int) -> "ArrayFeatureSet":
        """This process's contiguous shard for multi-host training: process p
        of `count` feeds rows [p*n/count, (p+1)*n/count) (the analog of a
        Spark partition pinned to an executor).  Row order must match across
        processes for the global-batch assembly in Estimator._shard."""
        if not (0 <= index < count):
            raise ValueError(f"partition index {index} not in [0, {count})")
        lo = (self._n * index) // count
        hi = (self._n * (index + 1)) // count
        return ArrayFeatureSet([x[lo:hi] for x in self.xs],
                               [y[lo:hi] for y in self.ys] or None,
                               self.memory_type)

    def split(self, fraction: float, seed: int = 0):
        """Random train/val split (reference FeatureSet has no built-in split; this
        replaces ad-hoc RDD randomSplit usage in examples)."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self._n)
        cut = int(self._n * fraction)
        a, b = idx[:cut], idx[cut:]

        def take(sel):
            return ArrayFeatureSet([x[sel] for x in self.xs],
                                   [y[sel] for y in self.ys] or None,
                                   self.memory_type)
        return take(a), take(b)


class IteratorFeatureSet(FeatureSet):
    """Wraps a user callable returning a fresh iterator of (x, y) batches per epoch
    (PythonLoaderFeatureSet parity without jep)."""

    def __init__(self, fn: Callable[[], Iterator], size: int):
        self.fn = fn
        self._n = size

    def size(self) -> int:
        return self._n

    def batches(self, batch_size: int, **kwargs):
        for item in self.fn():
            if len(item) == 2:
                x, y = item
                n = (x[0] if isinstance(x, (list, tuple)) else x).shape[0]
                yield x, y, np.ones((n,), np.float32)
            else:
                yield item
