"""Wide & Deep recommender — the JAX package's
``models/recommendation/wide_and_deep.py``.

Reference parity: models/recommendation/WideAndDeep.scala:101-365 —
``ColumnFeatureInfo`` declares wide (cross) columns, indicator columns,
embedding columns and continuous columns; ``model_type`` is one of wide,
deep and wide_n_deep.  The wide part is a linear model over the (bounded)
bucket space as a dense multi-hot product; the deep part embeds
categorical ids, concatenates them with the indicator and continuous
features and runs an MLP.  The graph and its layer names are the JAX
package's, so its param tree loads as it is.  ``_cross_columns`` and
``to_model_inputs`` are numpy, copied.

Inputs (as ``to_model_inputs`` builds them): [wide multi-hot (B,
wide_dim), indicator (B, ind_dim), embed ids (B, n_embed_cols),
continuous (B, cont_dim)], each present as the model type and the columns
ask.  Quantized by ``InferenceModel.do_quantize``, every ``Dense`` (the
unbiased wide layer included) runs the ``w8a8`` or ``w4a16`` kernel on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.context import DeviceLike
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.recommendation.recommender import \
    Recommender
from analytics_zoo_tpu_torch.nn.graph import Input, SymTensor
from analytics_zoo_tpu_torch.nn.layers.core import (Activation, Dense,
                                                    Embedding, Flatten,
                                                    Lambda, merge)
from analytics_zoo_tpu_torch.nn.models import Model


def _cross_columns(cross_name: str, columns: dict) -> List[str]:
    """Resolve a cross-column name ("colA_colB") into its component column
    names.  Column names may themselves contain underscores, so the split is
    a greedy longest-prefix match against the available columns (a naive
    split('_') silently matched nothing for e.g. 'education_id_occupation_id',
    leaving the cross feature constant)."""
    usable = {k for k, v in columns.items() if v is not None}
    tokens = cross_name.split("_")

    def solve(i: int) -> Optional[List[str]]:
        # longest-prefix first, but BACKTRACK on a failed suffix: with
        # columns {'a','a_b','b_c'} the name 'a_b_c' must resolve as
        # 'a'+'b_c' even though 'a_b' matches the longer prefix
        if i == len(tokens):
            return []
        for take in range(len(tokens) - i, 0, -1):
            cand = "_".join(tokens[i:i + take])
            # never match the whole cross name to itself (callers may pass it
            # as a None placeholder meaning "compute from parts")
            if cand in usable and cand != cross_name:
                rest = solve(i + take)
                if rest is not None:
                    return [cand] + rest
        return None

    out = solve(0)
    return out if out is not None else []


@dataclasses.dataclass
class ColumnFeatureInfo:
    """Column declaration (WideAndDeep.scala ColumnFeatureInfo)."""
    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()

    @property
    def wide_dim(self) -> int:
        return int(sum(self.wide_base_dims) + sum(self.wide_cross_dims))

    @property
    def indicator_dim(self) -> int:
        return int(sum(self.indicator_dims))


class WideAndDeep(ZooModel, Recommender):
    def __init__(self, class_num: int, column_info: ColumnFeatureInfo,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 device: DeviceLike = None):
        self.class_num = int(class_num)
        self.column_info = column_info
        self.model_type = model_type
        self.hidden_layers = tuple(hidden_layers)
        super().__init__(device)

    def build_model(self) -> Model:
        info = self.column_info
        inputs: List[SymTensor] = []
        merged = []

        if self.model_type in ("wide", "wide_n_deep") and info.wide_dim > 0:
            wide = Input(shape=(info.wide_dim,), name="wide_input")
            inputs.append(wide)
            merged.append(Dense(self.class_num, bias=False,
                                name="wad_wide_linear")(wide))

        if self.model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            if info.indicator_dim > 0:
                ind = Input(shape=(info.indicator_dim,),
                            name="indicator_input")
                inputs.append(ind)
                deep_parts.append(ind)
            if info.embed_cols:
                emb_in = Input(shape=(len(info.embed_cols),),
                               name="embed_input")
                inputs.append(emb_in)
                for i, (cin, cout) in enumerate(zip(info.embed_in_dims,
                                                    info.embed_out_dims)):
                    col = Lambda(lambda t, i=i: t[:, i:i + 1],
                                 name=f"wad_embed_slice{i}")(emb_in)
                    e = Embedding(cin + 1, cout, name=f"wad_embed{i}")(col)
                    deep_parts.append(Flatten(name=f"wad_embed_flat{i}")(e))
            if info.continuous_cols:
                cont = Input(shape=(len(info.continuous_cols),),
                             name="continuous_input")
                inputs.append(cont)
                deep_parts.append(cont)
            if not deep_parts:
                raise ValueError("deep model needs indicator/embed/continuous "
                                 "cols")
            h = (merge(deep_parts, mode="concat", name="wad_deep_concat")
                 if len(deep_parts) > 1 else deep_parts[0])
            for k, width in enumerate(self.hidden_layers):
                h = Dense(width, activation="relu", name=f"wad_deep_fc{k}")(h)
            merged.append(Dense(self.class_num, name="wad_deep_out")(h))

        logits = (merge(merged, mode="sum", name="wad_sum")
                  if len(merged) > 1 else merged[0])
        out = Activation("softmax", name="wad_softmax")(logits)
        return Model(input=inputs, output=out, name="WideAndDeep")

    # -- feature assembly (Utils.scala getWideTensor/getDeepTensor parity) ----
    def to_model_inputs(self, columns: dict) -> List[np.ndarray]:
        """columns: name -> (B,) arrays.  Builds the dense input list; cross-column
        hashing = product of base ids modulo the cross dim."""
        info = self.column_info
        B = len(next(iter(columns.values())))
        out: List[np.ndarray] = []
        if self.model_type in ("wide", "wide_n_deep") and info.wide_dim > 0:
            wide = np.zeros((B, info.wide_dim), np.float32)
            off = 0
            for c, d in zip(info.wide_base_cols, info.wide_base_dims):
                ids = np.asarray(columns[c], np.int64) % d
                wide[np.arange(B), off + ids] = 1.0
                off += d
            for cc, d in zip(info.wide_cross_cols, info.wide_cross_dims):
                parts = _cross_columns(cc, columns)
                if not parts:
                    raise ValueError(
                        f"cross column '{cc}' matches no input columns "
                        f"(have {sorted(columns)})")
                h = np.ones(B, np.int64)
                for pcol in parts:
                    h = h * (np.asarray(columns[pcol], np.int64) + 1)
                wide[np.arange(B), off + (h % d)] = 1.0
                off += d
            out.append(wide)
        if self.model_type in ("deep", "wide_n_deep"):
            if info.indicator_dim > 0:
                ind = np.zeros((B, info.indicator_dim), np.float32)
                off = 0
                for c, d in zip(info.indicator_cols, info.indicator_dims):
                    ids = np.asarray(columns[c], np.int64) % d
                    ind[np.arange(B), off + ids] = 1.0
                    off += d
                out.append(ind)
            if info.embed_cols:
                out.append(np.stack([np.asarray(columns[c], np.float32)
                                     for c in info.embed_cols], axis=1))
            if info.continuous_cols:
                out.append(np.stack([np.asarray(columns[c], np.float32)
                                     for c in info.continuous_cols], axis=1))
        return out
