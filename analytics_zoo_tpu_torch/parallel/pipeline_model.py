"""Estimator-trainable pipeline-parallel transformer; the JAX package's
``parallel/pipeline_model.py``.

``PipelinedTransformer`` is a GPT-style LM whose transformer blocks run
as GPipe stages over the mesh ``pipe`` axis (``parallel/pipeline.py``),
end to end through ``Estimator.fit``: the embeddings and the tied
embedding head are replicated, the S homogeneous stages' parameters are
STACKED on a leading axis placed ``P("pipe")`` (``sharding_plan()``), and
the forward microbatches the embedded activations through the schedule.
``pipelined=False`` applies the same stacked parameters as a plain
sequential loop: the one-rank reference.

The stacked tree keeps the JAX layout, ``stages/{attn: {qkv, out}, ffn:
{fc, proj}, ln1, ln2}`` with leaves (S, ...).  ``blocks_per_stage`` (1 in
JAX) runs that many blocks a stage, the leaves then (S, blocks, ...).
Stages are homogeneous, and in-pipeline dropout is not supported (the
block runs with rates 0), as in JAX.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from analytics_zoo_tpu_torch.common.context import PIPE_AXIS, get_context
from analytics_zoo_tpu_torch.nn.layers.attention import (TransformerBlock,
                                                         _ids, _take)
from analytics_zoo_tpu_torch.nn.module import Layer, to_shape
from analytics_zoo_tpu_torch.parallel.pipeline import (from_microbatches,
                                                       pipeline_apply,
                                                       stage_tree,
                                                       to_microbatches)
from analytics_zoo_tpu_torch.parallel.sharding import (P, Layout,
                                                       ShardingPlan,
                                                       check_specs,
                                                       row_axis, take_shard)


def _key(name: str) -> str:
    return name.replace(".", "__")


class PipelinedTransformer(Layer):
    """GPT-style LM over token ids, blocks pipelined over ``pipe``.

    Input (B, T) int ids; output (B, T, vocab) f32 logits (tied embedding
    head).  ``n_micro`` microbatches a global batch (B must divide)."""

    def __init__(self, vocab: int, hidden_size: int = 128, n_stages: int = 2,
                 n_head: int = 4, seq_len: int = 64, n_micro: int = 4,
                 intermediate_size: Optional[int] = None,
                 bidirectional: bool = False, pipelined: bool = True,
                 initializer_range: float = 0.02, mesh=None,
                 blocks_per_stage: int = 1, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.vocab = int(vocab)
        self.hidden_size = int(hidden_size)
        self.n_stages = int(n_stages)
        self.seq_len = int(seq_len)
        self.n_micro = int(n_micro)
        self.pipelined = bool(pipelined)
        self.blocks_per_stage = int(blocks_per_stage)
        self.std = initializer_range
        self._mesh = mesh
        # one template block, outside the module's parameters: every
        # stage shares its SHAPE, its values come from the stacked leaves
        block = TransformerBlock(
            hidden_size, n_head, intermediate_size=intermediate_size,
            causal=not bidirectional, attn_drop=0.0, resid_drop=0.0,
            initializer_range=initializer_range, name=self.name + "_stage")
        object.__setattr__(self, "block", block)
        self._names = [n for n, _ in block.named_parameters()]
        H = self.hidden_size
        self.wte = nn.Parameter(torch.empty(self.vocab, H))
        self.wpe = nn.Parameter(torch.empty(self.seq_len, H))
        lead = (self.n_stages,) if self.blocks_per_stage == 1 \
            else (self.n_stages, self.blocks_per_stage)
        self.stages = nn.ParameterDict({
            _key(n): nn.Parameter(torch.empty(lead + tuple(p.shape)))
            for n, p in block.named_parameters()})
        self.built = True
        with torch.no_grad():
            self.reset_parameters(torch.Generator().manual_seed(
                zlib.crc32(self.name.encode())))

    # -- params ---------------------------------------------------------------
    def reset_parameters(self, gen):
        self.wte.copy_(self.std * torch.randn(self.wte.shape, generator=gen))
        self.wpe.copy_(self.std * torch.randn(self.wpe.shape, generator=gen))
        per = self.n_stages * self.blocks_per_stage
        for i in range(per):
            self.block.reset_parameters(gen)
            for n, p in self.block.named_parameters():
                self.stages[_key(n)].view(
                    (per,) + tuple(p.shape))[i].copy_(p.detach())

    def _tree(self) -> Dict:
        stages: Dict = {}
        for n in self._names:
            node = stages
            parts = n.split(".")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = self.stages[_key(n)]
        return {"wte": self.wte, "wpe": self.wpe, "stages": stages}

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape)[:1] + (self.vocab,)

    @staticmethod
    def sharding_plan() -> ShardingPlan:
        """Estimator param_plan: stacked stage params over ``pipe``,
        embeddings replicated."""
        return ShardingPlan([(r"^stages/", P(PIPE_AXIS))])

    def shard_leaves(self, specs, mesh):
        """Pipeline form: each rank keeps its stage's slice of every
        stacked leaf."""
        ax = row_axis(specs.get("stages/ln1/gamma", ()))
        check_specs(self, specs, {
            **{"stages/" + n.replace(".", "/"): {(ax,)}
               for n in self._names}, "wte": {()}, "wpe": {()}})
        lays = {}
        for n in self._names:
            rel = "stages/" + n.replace(".", "/")
            lays[rel] = Layout(0, ax, 1)
            take_shard(self.stages, _key(n), lays[rel], mesh)
        return lays

    # -- forward --------------------------------------------------------------
    def _stage_fn(self, p, x):
        for j in range(self.blocks_per_stage):
            w = {n: (p[_key(n)] if self.blocks_per_stage == 1
                     else p[_key(n)][j]) for n in self._names}
            x = functional_call(self.block, w, (x,))
        return x

    def forward(self, x):
        ids = _ids(x).to(self.wte.device)
        T = ids.shape[1]
        h = _take(self.wte, ids) + self.wpe[:T]
        stacked = {k: v for k, v in self.stages.items()}
        if self.pipelined:
            mesh = self._mesh or get_context().mesh
            if mesh.size(PIPE_AXIS) != self.n_stages:
                raise ValueError(
                    f"mesh pipe axis {mesh.size(PIPE_AXIS)} != n_stages "
                    f"{self.n_stages}; build the context with mesh_axes "
                    f"including ('{PIPE_AXIS}', {self.n_stages})")
            hm = to_microbatches(h, self.n_micro)
            y = from_microbatches(pipeline_apply(self._stage_fn, stacked,
                                                 hm, mesh))
        else:
            y = h
            for i in range(self.n_stages):
                y = self._stage_fn(stage_tree(stacked, i), y)
        return torch.einsum("bth,vh->btv", y.to(torch.float32),
                            self.wte.to(torch.float32))
