"""MovieLens-1M data pipeline for the NCF ranking protocol — a copy of the
JAX package's ``models/recommendation/movielens.py`` (numpy only; the port
cannot import that file, whose package pulls in jax).

Reference parity: the NeuralCF example's dataset handling
(pyzoo/zoo/examples/recommendation/ncf_explicit_example.py and
models/recommendation/Utils.scala:1-327 — negative sampling, leave-one-out
split) over the ml-1m ``ratings.dat`` format (``UserID::MovieID::Rating::Ts``).

``load_or_synthesize`` reads a real ml-1m directory when one is present
(``ZOO_TPU_ML1M_DIR`` or ./data/ml-1m) and otherwise generates
``synthetic_ml1m``: a latent-factor surrogate with ML-1M's exact
dimensions — user/item factors drive interaction choice through a softmax
with Zipf item popularity, so the held-out item is predictable from the
training interactions and HR@10 / NDCG@10 measure collaborative-filtering
learning (an untrained model scores ~0.10 HR@10 = 10/100 chance).  Every
function returns the JAX package's arrays bit for bit for the same
arguments.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

ML1M_USERS = 6040
ML1M_ITEMS = 3706  # distinct movie ids actually rated in ml-1m


def load_ml1m(path: str) -> np.ndarray:
    """Parse ratings.dat → (N, 4) int64 [user, item, rating, timestamp].
    Movie ids are re-indexed densely (1..n_items) as the reference example
    does, since raw ml-1m movie ids are sparse up to 3952."""
    fname = os.path.join(path, "ratings.dat") if os.path.isdir(path) else path
    rows = []
    with open(fname, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) == 4:
                rows.append([int(p) for p in parts])
    data = np.asarray(rows, np.int64)
    # dense item re-index, stable by original id
    uniq = np.unique(data[:, 1])
    remap = np.zeros(uniq.max() + 1, np.int64)
    remap[uniq] = np.arange(1, len(uniq) + 1)
    data[:, 1] = remap[data[:, 1]]
    return data


def synthetic_ml1m(n_users: int = ML1M_USERS, n_items: int = ML1M_ITEMS,
                   ratings_per_user: int = 120, dim: int = 16,
                   seed: int = 7) -> np.ndarray:
    """Latent-factor surrogate at ML-1M scale (~725k interactions).

    Generative model: user factors p_u, item factors q_i ~ N(0, 0.6) so the
    affinity p_u . q_i has std ~1.4 against the Gumbel choice noise (std 1.28)
    — preferences, not noise, drive interaction choice; item base popularity
    log-linear in a Zipf rank (ML-1M's item frequency is heavy-tailed);
    user u's interaction set = top `ratings_per_user` items by
    (p_u . q_i + pop_i + gumbel noise) — the Gumbel-top-k trick, i.e. sampling
    without replacement from the softmax. Timestamps are the within-user
    sampling order, so leave-one-out holds out a typical (not adversarial)
    item. Ratings are thresholded affinities on a 1..5 scale (unused by the
    implicit-feedback NCF protocol but kept for format parity)."""
    g = np.random.default_rng(seed)
    p = g.normal(0, 0.6, (n_users, dim)).astype(np.float32)
    q = g.normal(0, 0.6, (n_items, dim)).astype(np.float32)
    pop = -0.8 * np.log(np.arange(1, n_items + 1))     # Zipf-ish, rank order
    pop = pop[g.permutation(n_items)].astype(np.float32)

    rows = []
    affinity_all = p @ q.T + pop[None, :]              # (U, I)
    for u in range(n_users):
        noise = g.gumbel(size=n_items).astype(np.float32)
        scores = affinity_all[u] + noise
        take = np.argpartition(-scores, ratings_per_user)[:ratings_per_user]
        # shuffle within-user order: the held-out "latest" item must be a
        # TYPICAL interaction, not the lowest-affinity one (score-sorted
        # order would make leave-one-out adversarial)
        take = take[g.permutation(ratings_per_user)]
        aff = affinity_all[u, take]
        rating = np.clip(np.round(3.0 + 1.5 * (aff - aff.mean())
                                  / (aff.std() + 1e-6)), 1, 5)
        for t, (i, r) in enumerate(zip(take, rating)):
            rows.append([u + 1, int(i) + 1, int(r), t])
    return np.asarray(rows, np.int64)


def load_or_synthesize(path: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """Real ml-1m if available, else the synthetic surrogate.
    Returns (ratings, source_tag)."""
    for cand in ([path] if path else []) + \
            [os.environ.get("ZOO_TPU_ML1M_DIR", ""), "data/ml-1m"]:
        if cand and os.path.exists(os.path.join(cand, "ratings.dat")):
            return load_ml1m(cand), f"ml-1m (real, {cand})"
    return synthetic_ml1m(), "synthetic-ml1m (zero-egress surrogate)"


def leave_one_out(ratings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Hold out each user's LATEST interaction for eval (the standard NCF
    protocol; Utils.scala's dataframe split analog).
    Returns (train_pos (M,2), test_pos (U,2)) as [user, item]."""
    order = np.lexsort((ratings[:, 3], ratings[:, 0]))
    r = ratings[order]
    users = r[:, 0]
    is_last = np.r_[users[1:] != users[:-1], True]
    test = r[is_last][:, :2]
    train = r[~is_last][:, :2]
    return train, test


def training_arrays(train_pos: np.ndarray, n_items: int, n_neg: int = 4,
                    seed: int = 0):
    """Positives + `n_neg` random negatives per positive
    (Utils.scala negative-sampling semantics; collisions with ANY known
    positive of the user are resampled once — residual collisions are rare
    and standard in NCF training). Returns shuffled (users, items, labels)
    float32 (N,1) arrays ready for Estimator.fit."""
    g = np.random.default_rng(seed)
    M = train_pos.shape[0]
    pos_set = set(map(tuple, train_pos.tolist()))
    users = np.repeat(train_pos[:, 0], 1 + n_neg).astype(np.int64)
    items = np.empty_like(users)
    labels = np.zeros_like(users)
    items[::1 + n_neg] = train_pos[:, 1]
    labels[::1 + n_neg] = 1
    neg = g.integers(1, n_items + 1, size=(M, n_neg))
    # one resampling round for collisions with the user's positives
    for col in range(n_neg):
        bad = np.fromiter(((int(u), int(i)) in pos_set
                           for u, i in zip(train_pos[:, 0], neg[:, col])),
                          bool, M)
        neg[bad, col] = g.integers(1, n_items + 1, size=int(bad.sum()))
    for col in range(n_neg):
        items[col + 1::1 + n_neg] = neg[:, col]
    perm = g.permutation(len(users))
    return (users[perm, None].astype(np.float32),
            items[perm, None].astype(np.float32),
            labels[perm, None].astype(np.float32))
