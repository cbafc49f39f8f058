"""PyTorch port: the paged ``ContinuousBatcher`` against the JAX package's.

Both batchers serve the request mix of ``tests/test_paged_kv.py`` (half
the prompts share a 16-token system prefix) over one set of weights — the
JAX param pytree, loaded into the port with ``load_jax_params`` — with the
prefix cache on, for f32 and int8 KV pools.  Greedy token sequences must
be identical, prefix hits must happen on both sides, and every pool block
must come back after the drain.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import generate as jgen
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.serving import generate as tgen

torch.set_num_threads(1)

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = dict(max_active_slots=4, max_tokens=5, max_prompt_len=24,
           stream_interval=0, decode_quantum=2, paged=True, block_len=8)


@pytest.fixture(scope="module")
def models():
    jlm = JaxLM(**GEO)
    params = jlm.build(jax.random.PRNGKey(0))
    jim = JaxInferenceModel().do_load_model(jlm, params, {})
    tlm = TransformerLM(**GEO, device="cpu")
    tim = InferenceModel(device="cpu").do_load_model(
        tlm, jax.tree.map(np.asarray, params))
    return jim, tim


def _shared_reqs(n=8, sys_len=16, pmax=24, vocab=48, budgets=(2, 3, 5)):
    """The mix of ``tests/test_paged_kv.py``: even prompts share a
    ``sys_len``-token system prefix."""
    g = np.random.default_rng(3)
    system = g.integers(1, vocab, sys_len).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            tail = g.integers(1, vocab, int(g.integers(1, pmax - sys_len
                                                       + 1)))
            prompt = np.concatenate([system, tail.astype(np.int32)])
        else:
            prompt = g.integers(1, vocab,
                                int(g.integers(2, pmax + 1))).astype(np.int32)
        reqs.append((f"r{i}", prompt, budgets[i % len(budgets)]))
    return reqs


def _drive(mod, batcher, reqs):
    for rid, prompt, budget in reqs:
        assert batcher.submit(mod.GenRequest(rid, prompt, max_tokens=budget))
    done = {}
    for _ in range(1000):
        for ev in batcher.step():
            assert ev.kind not in ("shed", "quarantine"), (ev.kind, ev.error)
            if ev.kind == "finish":
                done[ev.rid] = list(ev.tokens)
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"stalled: {len(done)}/{len(reqs)} finished")


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_paged_batcher_tokens_match_jax(models, kv_quant):
    jim, tim = models
    reqs = _shared_reqs()
    jb = jgen.ContinuousBatcher(
        jim, jgen.GenerationParams(kv_quant=kv_quant, **GEN))
    tb = tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(kv_quant=kv_quant, **GEN))
    want = _drive(jgen, jb, reqs)
    got = _drive(tgen, tb, reqs)
    assert got == want
    js, ts = jb.stats(), tb.stats()
    assert ts["pool"]["prefix_hits"] == js["pool"]["prefix_hits"] > 0
    for key in ("decode_steps", "generated_tokens", "admitted", "finished"):
        assert ts[key] == js[key], key
    assert tb.state_bytes_doc() == jb.state_bytes_doc()
    # the drain returns every block: what is still held is the prefix
    # cache's own hold, which eviction gives back
    assert tb.active == 0
    tb._prefix.evict_for(tb._pool.n_blocks)
    pool = tb.stats()["pool"]
    assert pool["free_blocks"] == pool["blocks"], pool


def test_pool_blocks_return_after_drain_without_prefix_cache(models):
    _, tim = models
    b = tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(prefix_cache=False, **GEN))
    _drive(tgen, b, _shared_reqs())
    pool = b.stats()["pool"]
    assert pool["free_blocks"] == pool["blocks"], pool
    assert b.active == 0 and b.idle


def test_pool_exhaustion_stalls_then_recovers(models):
    _, tim = models
    b = tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(pool_blocks=4, prefix_cache=False, **GEN))
    out = _drive(tgen, b, _shared_reqs(n=6))
    assert len(out) == 6 and b.pool_exhausted > 0


def test_prompts_validated_before_the_device(models):
    """Out-of-range, non-finite, empty and over-long prompts quarantine on
    the host (an out-of-range embedding index on CUDA is a device-side
    assert); the valid neighbour still finishes."""
    _, tim = models
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**GEN))
    bad = {"oob": np.array([1, 48], np.float32),
           "neg": np.array([-1, 2], np.float32),
           "nan": np.array([1, np.nan], np.float32),
           "empty": np.zeros((0,), np.float32),
           "long": np.ones((25,), np.float32)}
    for rid, p in bad.items():
        assert b.submit(tgen.GenRequest(rid, p))
    assert b.submit(tgen.GenRequest("ok", np.array([5, 6, 7], np.float32)))
    kinds = {}
    for _ in range(50):
        for ev in b.step():
            kinds.setdefault(ev.rid, set()).add(ev.kind)
        if b.idle:
            break
    for rid in bad:
        assert kinds[rid] == {"quarantine"}, (rid, kinds.get(rid))
    assert "finish" in kinds["ok"]
    assert b.quarantined == len(bad)


@pytest.mark.parametrize("gen", [dict(paged=True, checkpoint_interval=4),
                                 dict(paged=True, resume=True)])
def test_checkpoint_and_resume_modes_construct(models, gen):
    """Checkpointing and resume construct like the JAX batcher: the same
    prefill ladder (``resume`` extends it to pow2(max_prompt_len +
    max_tokens)), zeroed continuity counters, and nothing pending."""
    jim, tim = models
    gen = dict(GEN, max_tokens=12, **gen)
    tb = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    jb = jgen.ContinuousBatcher(jim, jgen.GenerationParams(**gen))
    assert tb.gen.prefill_buckets == jb.gen.prefill_buckets \
        == ([8, 16, 32, 64] if gen.get("resume") else [8, 16, 32])
    assert tb.gen.checkpoint_interval == jb.gen.checkpoint_interval
    keys = ("resumed", "resume_failed", "checkpoints", "snapshot_bytes",
            "can_resume")
    assert {k: tb.stats()[k] for k in keys} == \
        {k: jb.stats()[k] for k in keys}
    assert tb.drain_checkpoints() == [] == jb.drain_checkpoints()


def test_unported_models_and_warmup_raise(models):
    bare = InferenceModel(device="cpu").do_load_model(torch.nn.Linear(2, 2))
    with pytest.raises(NotImplementedError):
        tgen.ContinuousBatcher(bare, tgen.GenerationParams(paged=True))
