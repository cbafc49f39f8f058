"""Evaluation metrics as streaming (merge-able) accumulators — the JAX
package's ``nn/metrics.py``.

Each metric defines

    init() -> acc                              (dict of tensors)
    update(acc, y_pred, y_true, w) -> acc      (w = per-sample weights)
    result(acc) -> float

``init`` makes its accumulators on the CPU; ``update`` moves them to the
predictions' device once, so evaluation accumulates on the card and reads
back only in ``result``.
"""

from __future__ import annotations

import numpy as np
import torch


def _zeros(shape=()):
    return torch.zeros(shape, dtype=torch.float32)


def _on(acc, like):
    return {k: v.to(like.device) for k, v in acc.items()}


class Metric:
    name = "metric"

    def init(self):
        raise NotImplementedError

    def update(self, acc, y_pred, y_true, w):
        raise NotImplementedError

    def result(self, acc):
        raise NotImplementedError


def _binary_or_multiclass_pred(y_pred, y_true):
    """BigDL Accuracy semantics: a 1-unit sigmoid output is thresholded at
    0.5; otherwise argmax over the last axis (zero-based labels)."""
    if y_pred.shape[-1] == 1:
        pred = (y_pred[..., 0] > 0.5).to(torch.int32)
        true = y_true.reshape(pred.shape).to(torch.int32)
    else:
        pred = torch.argmax(y_pred, dim=-1).to(torch.int32)
        true = y_true
        if true.ndim == y_pred.ndim:
            if true.shape[-1] == y_pred.shape[-1]:   # one-hot
                true = torch.argmax(true, dim=-1)
            else:
                true = true[..., 0]
        true = true.to(torch.int32)
    return pred, true


class _Counting(Metric):
    """A weighted hit rate: ``{correct, total}``."""

    def init(self):
        return {"correct": _zeros(), "total": _zeros()}

    def result(self, acc):
        return float(acc["correct"] / acc["total"].clamp_min(1.0))


class Accuracy(_Counting):
    name = "accuracy"

    def __init__(self, zero_based_label: bool = True):
        self.zero_based = zero_based_label

    def update(self, acc, y_pred, y_true, w):
        acc = _on(acc, y_pred)
        pred, true = _binary_or_multiclass_pred(y_pred, y_true)
        if not self.zero_based and y_pred.shape[-1] > 1:
            true = true - 1
        wv = w.reshape(pred.shape).to(torch.float32)
        hit = (pred == true).to(torch.float32) * wv
        return {"correct": acc["correct"] + hit.sum(),
                "total": acc["total"] + wv.sum()}


class TopK(_Counting):
    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}_accuracy"

    def update(self, acc, y_pred, y_true, w):
        acc = _on(acc, y_pred)
        true = y_true
        if true.ndim == y_pred.ndim:
            true = true[..., 0]
        true = true.to(torch.long)
        idx = torch.topk(y_pred, self.k, dim=-1).indices
        hit = (idx == true[..., None]).any(dim=-1).to(torch.float32)
        wv = w.reshape(hit.shape).to(torch.float32)
        return {"correct": acc["correct"] + (hit * wv).sum(),
                "total": acc["total"] + wv.sum()}


def Top5Accuracy():
    """The reference's metric name."""
    return TopK(5)


class _Averaging(Metric):
    """A weighted per-sample mean: ``{sum, total}``."""

    def init(self):
        return {"sum": _zeros(), "total": _zeros()}

    def _accumulate(self, acc, per, w):
        acc = _on(acc, per)
        per = per.reshape(per.shape[0], -1).mean(dim=-1) * w
        return {"sum": acc["sum"] + per.sum(), "total": acc["total"] + w.sum()}

    def result(self, acc):
        return float(acc["sum"] / acc["total"].clamp_min(1.0))


class MAE(_Averaging):
    name = "mae"

    def update(self, acc, y_pred, y_true, w):
        err = (y_pred - y_true.reshape(y_pred.shape)).abs()
        return self._accumulate(acc, err, w)


class Loss(_Averaging):
    name = "loss"

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def update(self, acc, y_pred, y_true, w):
        return self._accumulate(acc, self.loss_fn(y_pred, y_true), w)


class AUC(Metric):
    """Streaming ROC-AUC by threshold bucketing (TP/FP/TN/FN per
    threshold)."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.n = num_thresholds
        eps = 1e-7
        self.thresholds = torch.from_numpy(np.concatenate(
            [[-eps], (np.arange(1, self.n - 1) / (self.n - 1)),
             [1.0 + eps]]).astype(np.float32))

    def init(self):
        return {key: _zeros((self.n,)) for key in ("tp", "fp", "tn", "fn")}

    def update(self, acc, y_pred, y_true, w):
        acc = _on(acc, y_pred)
        p = y_pred.reshape(-1)
        t = y_true.reshape(-1).to(torch.float32)
        wv = w.reshape(-1).to(torch.float32)
        thr = self.thresholds.to(p.device)
        above = (p[None, :] > thr[:, None]).to(torch.float32)
        pos = (t * wv)[None, :]
        neg = ((1 - t) * wv)[None, :]
        return {"tp": acc["tp"] + (above * pos).sum(-1),
                "fp": acc["fp"] + (above * neg).sum(-1),
                "fn": acc["fn"] + ((1 - above) * pos).sum(-1),
                "tn": acc["tn"] + ((1 - above) * neg).sum(-1)}

    def result(self, acc):
        tpr = acc["tp"] / (acc["tp"] + acc["fn"]).clamp_min(1e-7)
        fpr = acc["fp"] / (acc["fp"] + acc["tn"]).clamp_min(1e-7)
        # integrate TPR over FPR (thresholds descend in FPR)
        return float(((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
                     .sum())


_METRICS = {
    "accuracy": Accuracy, "acc": Accuracy,
    "top5accuracy": Top5Accuracy, "top5": Top5Accuracy,
    "mae": MAE, "auc": AUC,
}


def get(name):
    if isinstance(name, Metric):
        return name
    if isinstance(name, str):
        key = name.lower()
        if key in _METRICS:
            return _METRICS[key]()
    if callable(name):
        return name()
    raise ValueError(f"unknown metric {name!r}")
