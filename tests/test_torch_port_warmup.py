"""PyTorch port: the generation plane's warm-up and its monolithic lanes,
against the JAX package on the CPU.

- ``inference/aot.generation_manifest`` and ``ContinuousBatcher.
  warmup_manifest`` give the JAX package's entries, exactly, over a grid of
  modes (paged or monolithic, prefix cache, admission batches).
- ``warm()`` returns the JAX document's keys; on the CPU there are no CUDA
  graphs, so every entry runs once eagerly and nothing is captured, and
  the tokens served afterwards equal an unwarmed batcher's.
- Monolithic lanes (``paged=False``) give the JAX batcher's greedy tokens,
  exactly, over two capacity buckets with EOS and budget exits and slot
  refills; slots are conserved under churn; paged f32 tokens equal the
  monolithic ones (the counterpart of ``tests/test_paged_kv.py``'s
  paged-vs-monolithic check).
- The launch accounting around captured programs: a replay counts its
  replays and runs no wrapper; a wrapper under capture counts nothing.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference import aot as jaot
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import generate as jgen
from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.ops import _impl
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.serving import generate as tgen

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
# two monolithic lanes (32 and 64 tokens), prompts up to 24 tokens and
# budgets up to 12: requests land in both lanes
MONO = dict(max_active_slots=3, max_tokens=12, max_prompt_len=24,
            stream_interval=0, decode_quantum=2, paged=False,
            bucket_lens=[32, 64], eos_id=5)
PAGED = dict(max_active_slots=4, max_tokens=5, max_prompt_len=24,
             stream_interval=0, decode_quantum=2, paged=True, block_len=8)


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    """The JAX package at the f32 dtype policy (process-global; another
    test in the same worker may leave it at bf16)."""
    saved = dict(jdtypes._policy)
    jdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved)


@pytest.fixture(scope="module")
def models():
    jlm = JaxLM(**GEO)
    params = jlm.build(jax.random.PRNGKey(0))
    jim = JaxInferenceModel().do_load_model(jlm, params, {})
    tim = InferenceModel(device="cpu").do_load_model(
        TransformerLM(**GEO, device="cpu"),
        jax.tree.map(np.asarray, params))
    return jim, tim


def _reqs(n=10, seed=1, pmax=24, budgets=(1, 12)):
    g = np.random.default_rng(seed)
    return [(f"r{i}", g.integers(1, 48, int(g.integers(2, pmax + 1)))
             .astype(np.int32), int(g.integers(budgets[0], budgets[1] + 1)))
            for i in range(n)]


def _drive(mod, batcher, reqs, on_step=None):
    for rid, prompt, budget in reqs:
        assert batcher.submit(mod.GenRequest(rid, prompt, max_tokens=budget))
    done = {}
    for _ in range(1000):
        for ev in batcher.step():
            assert ev.kind not in ("shed", "quarantine"), (ev.kind, ev.error)
            if ev.kind == "finish":
                done[ev.rid] = (list(ev.tokens), ev.finish_reason)
        if on_step is not None:
            on_step(batcher)
        if len(done) == len(reqs):
            return done
    raise AssertionError(f"stalled: {len(done)}/{len(reqs)} finished")


# -- manifests ----------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("cache_model", [True, False])
@pytest.mark.parametrize("prefix_blocks", [(), (1, 2, 4)])
@pytest.mark.parametrize("batches", [(1,), (1, 2, 4, 8)])
def test_generation_manifest_matches_jax(paged, cache_model, prefix_blocks,
                                         batches):
    kw = dict(prefill_batches=batches, cache_model=cache_model, paged=paged,
              prefix_blocks=prefix_blocks)
    got = aot.generation_manifest([8, 16, 32, 64], [64, 16], **kw)
    want = jaot.generation_manifest([8, 16, 32, 64], [64, 16], **kw)
    assert got == want and len(got) > 1
    assert all(isinstance(e, aot.GenWarmupEntry) for e in got)


@pytest.mark.parametrize("gen", [
    dict(PAGED, prefix_cache=True), dict(PAGED, prefix_cache=False),
    dict(PAGED, kv_quant="int8", max_active_slots=3),
    MONO, dict(MONO, prefix_cache=False, max_active_slots=8),
    # resume extends the prefill ladder past max_prompt_len; the manifest
    # drops the buckets a lane cannot hold
    dict(PAGED, max_prompt_len=12, max_tokens=20, resume=True),
    dict(MONO, max_prompt_len=12, max_tokens=20, bucket_lens=[16, 32],
         resume=True)])
def test_batcher_warmup_manifest_matches_jax(models, gen):
    jim, tim = models
    jb = jgen.ContinuousBatcher(jim, jgen.GenerationParams(**gen))
    tb = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    assert tb.gen.prefill_buckets == jb.gen.prefill_buckets
    got, want = tb.warmup_manifest(), jb.warmup_manifest()
    assert got == want
    if gen.get("resume"):
        assert tb.gen.prefill_buckets == [8, 16, 32]
        assert max(e.prefill_bucket or 0 for e in got) == 32


# -- warm() -------------------------------------------------------------------

@pytest.mark.parametrize("gen", [dict(PAGED), dict(PAGED, kv_quant="int8"),
                                 MONO])
def test_warm_runs_every_entry_and_leaves_tokens_unchanged(models, gen):
    jim, tim = models
    reqs = _reqs(budgets=(1, 5) if gen["paged"] else (1, 12))
    want = _drive(tgen, tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(**gen)), reqs)
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    manifest = b.warmup_manifest()
    seen = []
    doc = b.warm(progress=lambda done, total, entry: seen.append(done),
                 stop=lambda: False)
    jdoc = jgen.ContinuousBatcher(
        jim, jgen.GenerationParams(**gen)).warm(manifest=[])
    assert set(doc) == set(jdoc)
    assert doc["programs"] == doc["compiled"] == len(manifest)
    assert doc["failed"] == doc["skipped"] == 0 and not doc["stopped"]
    assert doc["compile_stats"]["captures"] == 0 and b.captures == 0
    assert seen == list(range(1, len(manifest) + 1))
    assert b.program_stats()["count"] == len(manifest)
    again = b.warm()
    assert again["skipped"] == len(manifest) and again["compiled"] == 0
    # churn after the warm-up: two waves through the same batcher
    assert _drive(tgen, b, reqs) == want
    assert _drive(tgen, b, [(r + "b", p, n) for r, p, n in reqs]) == {
        r + "b": v for r, v in want.items()}
    st = b.stats()
    assert st["captures"] == st["replays"] == 0
    assert st["eager_quanta"] == st["decode_steps"] // gen["decode_quantum"]


def test_warm_stops_when_asked(models):
    _, tim = models
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**MONO))
    doc = b.warm(stop=lambda: True)
    assert doc["stopped"] and doc["compiled"] == 0


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_warm_beside_an_active_slot_leaves_its_tokens_unchanged(models,
                                                                kv_quant):
    """A warm-up between two boundaries of a serving lane: the decode entry
    must not dry-run the quantum over active rows (in int8 that would park
    values ahead of a slot's cursor in its staging block and change the
    block's scale), and the prefill entries commit to the trash block."""
    _, tim = models
    gen = dict(PAGED, kv_quant=kv_quant)
    reqs = _reqs(n=4, budgets=(5, 5))
    want = _drive(tgen, tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(**gen)), reqs)
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    warmed = []

    def warm_once(batcher):
        if not warmed and batcher.active:
            warmed.append(batcher.warm())
    assert _drive(tgen, b, reqs, on_step=warm_once) == want
    assert warmed and warmed[0]["failed"] == 0


def test_warm_entry_of_an_unknown_lane_fails_alone(models):
    _, tim = models
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**MONO))
    bad = [aot.GenWarmupEntry("decode_step", None, 128),
           aot.GenWarmupEntry("paged_decode", None, 32)]
    doc = b.warm(manifest=bad + b.warmup_manifest()[:1])
    assert doc["failed"] == 2 and doc["compiled"] == 1


# -- monolithic lanes ---------------------------------------------------------

@pytest.mark.parametrize("quantum", [1, 3])
def test_monolithic_tokens_match_jax(models, quantum):
    jim, tim = models
    gen = dict(MONO, decode_quantum=quantum)
    # two prompts that only the 64-token lane holds, among the mix
    reqs = _reqs(n=12, seed=4) + [
        (f"long{i}", np.arange(1 + i, 23 + i, dtype=np.int32), 12)
        for i in range(2)]
    jb = jgen.ContinuousBatcher(jim, jgen.GenerationParams(**gen))
    tb = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**gen))
    want = _drive(jgen, jb, reqs)
    got = _drive(tgen, tb, reqs)
    assert got == want
    reasons = {v[1] for v in want.values()}
    assert reasons == {"eos", "length"}
    js, ts = jb.stats(), tb.stats()
    for key in ("decode_steps", "generated_tokens", "admitted", "finished",
                "slots_total"):
        assert ts[key] == js[key], key
    # both lanes served and refilled: more admissions than slots
    assert {p.split("@")[1] for p in tb.program_stats()["programs"]} == {
        "32", "64"}
    assert ts["admitted"] > ts["slots_total"]
    assert tb.program_stats()["programs"] == jb.program_stats()["programs"]
    assert tb.state_bytes_doc() == jb.state_bytes_doc()


def test_monolithic_slots_are_conserved_under_churn(models):
    _, tim = models
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(**MONO))

    def conserved(batcher):
        assert batcher.active == (batcher.admitted - batcher.finished)
        for lane in batcher._lanes:
            busy = [s for s, info in enumerate(lane.slots) if info]
            assert sorted(busy + list(lane.free)) == list(
                range(lane.max_active))
    out = _drive(tgen, b, _reqs(n=16, seed=9), on_step=conserved)
    assert len(out) == 16 and b.idle
    assert all(len(lane.free) == lane.max_active for lane in b._lanes)


def test_monolithic_quarantines_what_no_lane_holds(models):
    _, tim = models
    b = tgen.ContinuousBatcher(tim, tgen.GenerationParams(
        **dict(MONO, bucket_lens=[32])))
    assert b.submit(tgen.GenRequest("big", np.arange(1, 25, dtype=np.int32),
                                    max_tokens=12))
    assert b.submit(tgen.GenRequest("ok", np.array([3, 4], np.int32)))
    kinds = {}
    while not b.idle:
        for ev in b.step():
            kinds.setdefault(ev.rid, set()).add(ev.kind)
    assert kinds["big"] == {"quarantine"} and "finish" in kinds["ok"]


def test_paged_f32_tokens_equal_monolithic(models):
    """The paged lane (block pool, prefix cache) and a monolithic lane of
    the same capacity serve the same greedy tokens."""
    _, tim = models
    reqs = _reqs(n=8, seed=6, budgets=(3, 8))
    common = dict(max_active_slots=3, max_tokens=8, max_prompt_len=24,
                  stream_interval=0, decode_quantum=2, bucket_lens=[32])
    mono = _drive(tgen, tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(paged=False, **common)), reqs)
    paged = _drive(tgen, tgen.ContinuousBatcher(
        tim, tgen.GenerationParams(paged=True, block_len=8, **common)),
        reqs)
    assert paged == mono


# -- captured programs ----------------------------------------------------------

def test_capture_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        aot.capture(lambda: None, (), torch.device("cpu"))


def test_replay_counts_its_replays_and_adds_no_launches():
    """A replay counts on its program and in ``CAPTURE_STATS``; the
    kernel wrappers' counters are left alone (a replay runs no wrapper:
    its launches are counted on the card, ``_impl.card_launches``)."""
    class _Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    n0 = tpa.launches
    s0 = aot.CAPTURE_STATS.snapshot()["replays"]
    out = torch.zeros(2)
    prog = aot.CapturedProgram(_Graph(), (), out)
    assert prog.replay() is out and prog.replay() is out
    assert prog.replays == prog.graph.replays == 2
    assert aot.CAPTURE_STATS.snapshot()["replays"] == s0 + 2
    assert tpa.launches == n0


def test_wrappers_count_nothing_under_capture(monkeypatch):
    """A wrapper adds 1 where it launches its kernel, and 0 while its
    stream is capturing a CUDA graph (the capture runs nothing)."""
    assert _impl.launched() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert _impl.launched() == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert _impl.launched() == 1


def test_card_launches_count_nothing_without_a_card():
    with _impl.card_launches() as counts:
        pass
    assert counts == {k: 0 for k in _impl.KERNEL_NAMES}
