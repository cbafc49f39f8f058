"""Recommender base, ranking evaluation and negative sampling — a copy of
the JAX package's ``models/recommendation/recommender.py``: numpy around
``model.predict``.

Reference parity: ``Recommender.recommendForUser/recommendForItem``
(models/recommendation/Recommender.scala:36-105), negative-sampling
utilities (models/recommendation/Utils.scala:1-327) and NDCG/HR ranking
evaluation (models/common/Ranker.scala:1-175).  The scoring sweep over
candidate items is batched forwards (a user broadcast against the item
vocabulary).  ``evaluate_ranking`` takes anything with
``predict([users, items], batch_size=)``: a zoo model, or an
``InferenceModel`` holding one (its ``predict`` is ``do_predict``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    label: Optional[int] = None


@dataclasses.dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender:
    """Mixin for models taking [user_ids, item_ids] inputs and emitting class probs."""

    def recommend_for_user(self, user_ids: Sequence[int], max_items: int,
                           item_count: Optional[int] = None,
                           batch_size: int = 8192) -> List[UserItemPrediction]:
        item_count = item_count or self.item_count
        items = np.arange(1, item_count + 1, dtype=np.float32)
        out: List[UserItemPrediction] = []
        for uid in user_ids:
            users = np.full_like(items, float(uid))
            probs = self.predict([users[:, None], items[:, None]],
                                 batch_size=batch_size)
            score, cls = _score_and_class(probs)
            top = np.argsort(-score)[:max_items]
            out.extend(UserItemPrediction(int(uid), int(items[i]), int(cls[i]),
                                          float(score[i])) for i in top)
        return out

    def recommend_for_item(self, item_ids: Sequence[int], max_users: int,
                           user_count: Optional[int] = None,
                           batch_size: int = 8192) -> List[UserItemPrediction]:
        user_count = user_count or self.user_count
        users = np.arange(1, user_count + 1, dtype=np.float32)
        out: List[UserItemPrediction] = []
        for iid in item_ids:
            items = np.full_like(users, float(iid))
            probs = self.predict([users[:, None], items[:, None]],
                                 batch_size=batch_size)
            score, cls = _score_and_class(probs)
            top = np.argsort(-score)[:max_users]
            out.extend(UserItemPrediction(int(users[i]), int(iid), int(cls[i]),
                                          float(score[i])) for i in top)
        return out


def _score_and_class(probs: np.ndarray):
    """Score = max class probability weighted by predicted rating (argmax class)."""
    cls = probs.argmax(-1)
    return probs.max(-1), cls


# -- negative sampling (Utils.scala parity) ----------------------------------

def generate_negative_samples(user_item_pairs: np.ndarray, item_count: int,
                              neg_per_pos: int = 1, seed: int = 0) -> np.ndarray:
    """For each observed (user, item) pair, draw `neg_per_pos` unobserved items for the
    same user.  Returns an array of (user, item) negative pairs."""
    rng = np.random.default_rng(seed)
    seen = set(map(tuple, user_item_pairs.astype(np.int64)))
    users = user_item_pairs[:, 0].astype(np.int64)
    negs = []
    for u in np.repeat(users, neg_per_pos):
        while True:
            j = int(rng.integers(1, item_count + 1))
            if (u, j) not in seen:
                negs.append((u, j))
                break
    return np.asarray(negs, np.int64)


# -- ranking metrics (NCF leave-one-out protocol) ----------------------------

def hit_ratio(scores: np.ndarray, k: int = 10) -> float:
    """scores: (B, 1+num_neg), positive score in column 0.  HR@k = fraction of rows
    where the positive ranks in the top k."""
    rank = (scores[:, 1:] > scores[:, :1]).sum(-1)
    return float((rank < k).mean())


def ndcg(scores: np.ndarray, k: int = 10) -> float:
    """NDCG@k under one relevant item per row: 1/log2(rank+2) if rank < k else 0."""
    rank = (scores[:, 1:] > scores[:, :1]).sum(-1)
    gain = np.where(rank < k, 1.0 / np.log2(rank + 2.0), 0.0)
    return float(gain.mean())


def evaluate_ranking(model, test_pos: np.ndarray, item_count: int,
                     num_neg: int = 100, k: int = 10, seed: int = 0,
                     batch_size: int = 8192, positive_class: int = 1,
                     exclude_pos=None):
    """Leave-one-out ranking eval: for each (user, pos_item), score against `num_neg`
    random negatives; report HR@k and NDCG@k.  `positive_class` indexes the probability
    column used as the ranking score (binary NCF: class 1).

    `exclude_pos`: optional {user_id: set(item_ids)} of known interactions —
    negatives colliding with them are resampled, matching the reference
    protocol (Utils.scala samples negatives the user has NOT interacted
    with; without this, a user's own training positives appear among the
    negatives and unfairly outrank the held-out item)."""
    rng = np.random.default_rng(seed)
    B = test_pos.shape[0]
    cand = np.empty((B, 1 + num_neg), np.float32)
    cand[:, 0] = test_pos[:, 1]
    neg = rng.integers(1, item_count + 1, size=(B, num_neg))
    if exclude_pos is not None:
        # vectorized rejection: encode (user, item) pairs as int keys and
        # redraw colliding entries against the flat seen-key set
        seen_keys = np.fromiter(
            (u * (item_count + 1) + i
             for u, items in exclude_pos.items() for i in items),
            np.int64)
        seen_keys = np.sort(seen_keys)
        urep = test_pos[:, 0].astype(np.int64)[:, None] * (item_count + 1)
        for _ in range(20):
            bad = np.isin(urep + neg, seen_keys)
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            neg[bad] = rng.integers(1, item_count + 1, size=n_bad)
    cand[:, 1:] = neg
    users = np.repeat(test_pos[:, 0].astype(np.float32), 1 + num_neg)[:, None]
    items = cand.reshape(-1)[:, None]
    probs = model.predict([users, items], batch_size=batch_size)
    scores = probs[:, positive_class].reshape(B, 1 + num_neg)
    return {"hit_ratio": hit_ratio(scores, k), "ndcg": ndcg(scores, k)}
