"""Preprocessing chains — composable sample transforms; the port's own copy
of the JAX package's ``feature/common.py`` (numpy only, nothing of JAX).

Reference parity: `Preprocessing[A,B]` with `->` chaining
(feature/common/Preprocessing.scala:1-82), FeatureLabelPreprocessing, and the
Sample/MiniBatch converters.  Python has no `->` operator; chaining uses `>>`
(`a >> b` == reference `a -> b`) or `ChainedPreprocessing([a, b, c])`.

Transforms run on the host CPU (the host decodes and augments, the device does
the math), so they are plain-python per-sample functions batched by the FeatureSet
iterator.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import numpy as np


class Preprocessing:
    """A sample transform.  Subclasses implement `transform(sample) -> sample`."""

    def transform(self, sample):
        raise NotImplementedError

    def __call__(self, samples):
        """Apply to one sample or map over an iterable of samples."""
        if isinstance(samples, (list, tuple)):
            return [self.transform(s) for s in samples]
        return self.transform(samples)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    def __init__(self, stages: List[Preprocessing]):
        self.stages = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def transform(self, sample):
        for s in self.stages:
            sample = s.transform(sample)
        return sample

    def __rshift__(self, other):
        return ChainedPreprocessing(self.stages + [other])


class FnPreprocessing(Preprocessing):
    def __init__(self, fn: Callable):
        self.fn = fn

    def transform(self, sample):
        return self.fn(sample)


class FeatureLabelPreprocessing(Preprocessing):
    """Zip a feature transform and a label transform over (feature, label) tuples
    (FeatureLabelPreprocessing.scala:1-73)."""

    def __init__(self, feature_pre: Preprocessing,
                 label_pre: Optional[Preprocessing] = None):
        self.feature_pre = feature_pre
        self.label_pre = label_pre

    def transform(self, sample):
        f, l = sample
        f = self.feature_pre.transform(f)
        if self.label_pre is not None:
            l = self.label_pre.transform(l)
        return f, l


class ScalarToTensor(Preprocessing):
    def transform(self, sample):
        return np.asarray([sample], np.float32)


class ArrayToTensor(Preprocessing):
    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def transform(self, sample):
        return np.asarray(sample, self.dtype)
