"""TextSet, the text transforms and Relations — a copy of the JAX
package's ``feature/text.py`` (pure Python and numpy, host side).

Reference parity: `TextSet` (feature/text/TextSet.scala:43-712) with the transform ops
(Tokenizer, Normalizer, WordIndexer, SequenceShaper, TextFeatureToSample) and `Relations`
for ranking pairs/lists (feature/common/Relations.scala:1-154).  The output of
`gen_sample()` / relation builders are padded numpy id arrays ready for the
FeatureSet → device path; the ids and labels equal the JAX package's for the
same texts (`word2idx` keeps `Counter.most_common`'s order).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import re
import string
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class TextFeature(dict):
    """Per-text record: `text`, optional `label`, gains `tokens`/`indexed_tokens`."""

    @staticmethod
    def of(text: str, label: Optional[int] = None) -> "TextFeature":
        f = TextFeature(text=text)
        if label is not None:
            f["label"] = label
        return f


class TextSet:
    def __init__(self, features: List[TextFeature]):
        self.features = features
        self.word_index: Optional[Dict[str, int]] = None

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        return TextSet([TextFeature.of(t, labels[i] if labels is not None
                                       else None)
                        for i, t in enumerate(texts)])

    @staticmethod
    def read_csv(path: str, text_col: str = "text",
                 label_col: Optional[str] = "label") -> "TextSet":
        feats = []
        with open(path) as f:
            for row in csv.DictReader(f):
                label = (int(row[label_col])
                         if label_col and label_col in row else None)
                feats.append(TextFeature.of(row[text_col], label))
        return TextSet(feats)

    def __len__(self):
        return len(self.features)

    # -- transforms (each returns self for chaining, matching TextSet API) ----
    def tokenize(self) -> "TextSet":
        for f in self.features:
            f["tokens"] = re.findall(r"[\w']+", f["text"])
        return self

    def normalize(self) -> "TextSet":
        table = str.maketrans("", "", string.punctuation)
        for f in self.features:
            f["tokens"] = [t.lower().translate(table) for t in f["tokens"]]
            f["tokens"] = [t for t in f["tokens"] if t]
        return self

    def word2idx(self, remove_topN: int = 0,
                 max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        """Build the word index (1-based; 0 reserved for padding/unknown) and map
        tokens (TextSet.word2idx semantics)."""
        if existing_map is not None:
            self.word_index = dict(existing_map)
        else:
            counts = Counter(t for f in self.features for t in f["tokens"])
            ordered = [w for w, c in counts.most_common() if c >= min_freq]
            ordered = ordered[remove_topN:]
            if max_words_num > 0:
                ordered = ordered[:max_words_num]
            self.word_index = {w: i + 1 for i, w in enumerate(ordered)}
        wi = self.word_index
        for f in self.features:
            f["indexed_tokens"] = [wi.get(t, 0) for t in f["tokens"]]
        return self

    def shape_sequence(self, length: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        """Pad/truncate indexed tokens to fixed length (SequenceShaper.scala)."""
        for f in self.features:
            ids = f["indexed_tokens"]
            if len(ids) > length:
                ids = ids[-length:] if trunc_mode == "pre" else ids[:length]
            else:
                ids = ids + [pad_element] * (length - len(ids))
            f["indexed_tokens"] = ids
        return self

    def gen_sample(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(ids (N, L) float32, labels (N, 1) or None) — TextFeatureToSample."""
        x = np.asarray([f["indexed_tokens"] for f in self.features], np.float32)
        if "label" in self.features[0]:
            y = np.asarray([[f["label"]] for f in self.features], np.float32)
        else:
            y = None
        return x, y

    def get_word_index(self) -> Dict[str, int]:
        return self.word_index or {}

    def save_word_index(self, path: str):
        with open(path, "w") as f:
            json.dump(self.word_index, f)

    def load_word_index(self, path: str) -> "TextSet":
        with open(path) as f:
            self.word_index = json.load(f)
        return self

    def to_distributed(self, num_shards: int = 1) -> List["TextSet"]:
        """Shard into per-host subsets (DistributedTextSet ≙ host-sharded lists)."""
        shards = [[] for _ in range(num_shards)]
        for i, f in enumerate(self.features):
            shards[i % num_shards].append(f)
        return [TextSet(s) for s in shards]


# -- Relations (ranking pairs/lists, Relations.scala) -------------------------

@dataclasses.dataclass
class Relation:
    id1: str
    id2: str
    label: int


def read_relations(path: str) -> List[Relation]:
    """CSV with columns id1,id2,label."""
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out.append(Relation(row["id1"], row["id2"], int(row["label"])))
    return out


def generate_relation_pairs(relations: Sequence[Relation],
                            seed: int = 0) -> List[Tuple[str, str, str]]:
    """(id1, pos_id2, neg_id2) triples for pairwise ranking (RankHinge training):
    every positive of id1 is paired with a sampled negative of the same id1."""
    rng = np.random.default_rng(seed)
    by_q: Dict[str, Dict[int, List[str]]] = {}
    for r in relations:
        by_q.setdefault(r.id1, {}).setdefault(r.label, []).append(r.id2)
    out = []
    for q, groups in by_q.items():
        pos, neg = groups.get(1, []), groups.get(0, [])
        if not pos or not neg:
            continue
        for p in pos:
            out.append((q, p, neg[int(rng.integers(0, len(neg)))]))
    return out


def generate_relation_lists(relations: Sequence[Relation]
                            ) -> Dict[str, List[Tuple[str, int]]]:
    """id1 -> [(id2, label)] for listwise evaluation (NDCG/MAP)."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for r in relations:
        out.setdefault(r.id1, []).append((r.id2, r.label))
    return out


def relation_pairs_to_arrays(pairs, corpus1: Dict[str, Sequence[int]],
                             corpus2: Dict[str, Sequence[int]]):
    """Interleave (pos, neg) rows — the RankHinge batch layout
    (objectives.rank_hinge expects [pos0, neg0, pos1, neg1, ...])."""
    q, d = [], []
    for (qid, pid, nid) in pairs:
        q.append(corpus1[qid])
        d.append(corpus2[pid])
        q.append(corpus1[qid])
        d.append(corpus2[nid])
    return np.asarray(q, np.float32), np.asarray(d, np.float32)
