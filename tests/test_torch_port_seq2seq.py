"""PyTorch port: ``models/seq2seq.Seq2seq`` and the generation plane's
bare-state lanes, against the JAX package on the CPU.

- ``Seq2seq`` with 1 and 2 layers and every bridge (passthrough, None,
  dense, densenonlinear, a callable), the JAX weights carried across by
  ``load_jax_params``: the teacher-forced ``call`` (and its gradients),
  ``init_decode`` with and without ``lengths`` (a padded batch row by row
  against the unpadded prompts), ``decode_step``, ``infer`` with
  ``stop_sign`` and ``return_lengths``; ``Estimator.fit`` step by step.
- The port's ``ContinuousBatcher`` serves ``Seq2seq`` requests to the JAX
  batcher's tokens exactly, before and after ``warm()``: the first lane,
  budgets not clipped by the lane, every prompt bucket, ``start_id`` as
  the first decoder token; its manifest is the JAX batcher's; it takes
  no checkpoint (``can_resume`` False); a resume is downgraded with the
  JAX event; ``paged=True`` raises.
- ``ClusterServing`` in generation mode (warm-up on) serves the same
  tokens, and reclaims a dead owner's record that carries a snapshot as
  the JAX engine does: restarted from 0, with its events.

Tolerances: TOL = 1e-5 on probabilities, states and gradients (f32 in
another summation order, read at ~1e-7); tokens exactly (the seeded
weights leave no top-2 logit margin within 1e-4 on these prompts).
"""

import base64
import os
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.common.context import get_context as jax_context
from analytics_zoo_tpu.estimator.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxIM
from analytics_zoo_tpu.models.seq2seq import Seq2seq as JaxSeq2seq
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import generate as jgen
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu.serving import tracecollect as jtc
from analytics_zoo_tpu_torch.common import dtypes as tdtypes
from analytics_zoo_tpu_torch.common.context import ZooConf, ZooContext
from analytics_zoo_tpu_torch.common.observability import MetricsRegistry
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.serving import tracecollect as ttc
from analytics_zoo_tpu_torch.utils.convert import (export_params,
                                                   load_jax_params)

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

TOL = 1e-5
VOCAB, EMBED = 32, 8


@pytest.fixture(scope="module", autouse=True)
def _f32_policy():
    saved_j, saved_t = dict(jdtypes._policy), dict(tdtypes._policy)
    jdtypes.set_policy(None)
    tdtypes.set_policy(None)
    yield
    jdtypes._policy.update(saved_j)
    tdtypes._policy.update(saved_t)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _half(flat):
    return flat * 0.5


BRIDGES = {"passthrough": "passthrough", "none": None, "dense": "dense",
           "densenonlinear": "densenonlinear", "callable": _half}


def _pair(hidden=(16,), bridge="dense", seed=0):
    jm = JaxSeq2seq(VOCAB, embed_dim=EMBED, hidden_sizes=hidden,
                    bridge=bridge)
    params = _np(jm.build(jax.random.PRNGKey(seed)))
    # biases moved off zero, so that they count
    g = np.random.default_rng(seed)
    for stack in ("encoder", "decoder"):
        for p in params[stack]:
            p["b"] = (0.1 * g.standard_normal(p["b"].shape)).astype(
                np.float32)
    params["out"]["b"] = (0.1 * g.standard_normal(VOCAB)).astype(np.float32)
    tm = Seq2seq(VOCAB, embed_dim=EMBED, hidden_sizes=hidden, bridge=bridge,
                 device="cpu")
    load_jax_params(tm, params)
    return jm, tm, params


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(
        0, VOCAB, shape).astype(np.float32)


def _states(st):
    return [np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                       else t) for hc in st for t in hc]


MODEL_CASES = [(h, b) for h in ((16,), (12, 10)) for b in sorted(BRIDGES)]


@pytest.mark.parametrize("hidden,bridge", MODEL_CASES)
def test_seq2seq_call_and_gradients_match_jax(hidden, bridge):
    jm, tm, params = _pair(hidden, BRIDGES[bridge], seed=len(hidden))
    enc, dec = _ids(1, (3, 5)), _ids(2, (3, 4))
    want = np.asarray(jm.call(params, [enc, dec]))
    tm.train()
    got = tm([torch.from_numpy(enc), torch.from_numpy(dec)])
    assert tuple(got.shape) == want.shape == (3, 4, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    cot = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    gj = jax.grad(lambda p: jnp.sum(jm.call(p, [enc, dec]) * cot))(params)
    (got * torch.from_numpy(cot)).sum().backward()
    want_g = jax.tree_util.tree_leaves_with_path(_np(gj))
    grads = {"embed": tm.embed.grad, "out": {"W": tm.out_W.grad,
                                              "b": tm.out_b.grad},
             "encoder": [{k: v.grad for k, v in c.tree().items()}
                         for c in tm.encoder],
             "decoder": [{k: v.grad for k, v in c.tree().items()}
                         for c in tm.decoder]}
    if tm.has_bridge_W:
        grads["bridge"] = {"W": tm.bridge_W.grad}
    got_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), grads)))
    assert len(got_g) == len(want_g)
    for path, leaf in want_g:
        np.testing.assert_allclose(got_g[path], leaf, atol=TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("hidden,bridge", MODEL_CASES)
def test_seq2seq_decode_api_matches_jax(hidden, bridge):
    """``init_decode`` without lengths (the monolithic encoder) and with
    them over a right-padded batch; ``decode_step`` from both; the padded
    rows' states equal the unpadded prompts' own, so rows of a batch stay
    independent."""
    jm, tm, params = _pair(hidden, BRIDGES[bridge], seed=5)
    enc = _ids(4, (3, 6))
    lengths = np.array([6, 2, 4], np.int32)
    padded = enc.copy()
    for j, n in enumerate(lengths):
        padded[j, n:] = 0
    for x, lens in ((enc, None), (padded, lengths)):
        jst = jm.init_decode(params, x, lens)
        tst = tm.init_decode(x, lens)
        for a, b in zip(_states(tst), _states(jst)):
            np.testing.assert_allclose(a, b, atol=TOL)
        tok = np.array([1, 7, 30], np.int32)
        jl, jst2 = jm.decode_step(params, jst, tok)
        tl, tst2 = tm.decode_step(tst, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        for a, b in zip(_states(tst2), _states(jst2)):
            np.testing.assert_allclose(a, b, atol=TOL)
    full = tm.init_decode(padded, lengths)
    for j, n in enumerate(lengths):
        own = tm.init_decode(enc[j:j + 1, :n])
        for a, b in zip(_states(full), _states(own)):
            np.testing.assert_allclose(a[j:j + 1], b, atol=1e-6)


@pytest.mark.parametrize("hidden", [(16,), (12, 10)])
def test_seq2seq_infer_matches_jax(hidden):
    """Tokens exactly: free-running, with a stop sign that fires mid-row
    (frozen rows, their lengths), trimmed; and the step-wise rollout of
    ``decode_step`` equals ``infer``."""
    jm, tm, params = _pair(hidden, "dense", seed=7)
    enc = _ids(8, (4, 5))
    free_j = jm.infer(params, enc, start_sign=1, max_seq_len=10)
    free_t = tm.infer(enc, start_sign=1, max_seq_len=10)
    np.testing.assert_array_equal(free_t, free_j)
    stop = int(free_j[0, 3])
    tj, lj = jm.infer(params, enc, start_sign=1, max_seq_len=10,
                      stop_sign=stop, return_lengths=True)
    tt, lt = tm.infer(enc, start_sign=1, max_seq_len=10, stop_sign=stop,
                      return_lengths=True)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(lt, lj)
    assert lt.min() < 10
    for row, n in zip(tt, lt):
        assert set(row[n:]) <= {stop}
    trimmed = tm.infer(enc, start_sign=1, max_seq_len=10, stop_sign=stop)
    assert [list(r) for r in trimmed] == [list(r[:n])
                                          for r, n in zip(tj, lj)]
    st = tm.init_decode(enc)
    tok = torch.full((4,), 1, dtype=torch.int32)
    steps = []
    for _ in range(10):
        logits, st = tm.decode_step(st, tok)
        tok = logits.argmax(-1).to(torch.int32)
        steps.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(steps, 1), free_t)


def test_seq2seq_tree_and_ids():
    tm = Seq2seq(VOCAB, embed_dim=EMBED, hidden_sizes=(6, 4), device="cpu")
    tree = export_params(tm)
    assert sorted(tree) == ["bridge", "decoder", "embed", "encoder", "out"]
    assert [tuple(p["Wx"].shape) for p in tree["encoder"]] == [(8, 24),
                                                               (6, 16)]
    assert tuple(tree["bridge"]["W"].shape) == (20, 20)
    assert "bridge" not in export_params(Seq2seq(
        VOCAB, hidden_sizes=(4,), bridge=None, device="cpu"))
    with pytest.raises(ValueError):
        Seq2seq(VOCAB, bridge="conv", device="cpu")
    # float ids truncate, [-V, -1] wraps, ids past the table give NaN
    emb = tm._embed(torch.tensor([[2.7, -1.0, 40.0]]))
    np.testing.assert_array_equal(emb[0, 0].detach(), tm.embed[2].detach())
    np.testing.assert_array_equal(emb[0, 1].detach(),
                                  tm.embed[VOCAB - 1].detach())
    assert torch.isnan(emb[0, 2]).all()


def test_seq2seq_fit_matches_jax():
    """``Estimator.fit`` of the teacher-forced forward, step by step
    against the JAX ``Estimator`` (sparse categorical cross-entropy over
    every decoder position, Adam 1e-2, batch 8): each step's loss within
    TOL, and the trained parameters within 5e-5."""
    jm, tm, params = _pair((12, 10), "dense", seed=9)
    enc, dec = _ids(10, (24, 5)), _ids(11, (24, 4))
    y = _ids(12, (24, 4))
    jax_context().set_seed(42)
    jm.set_weights(params, {})
    je = JaxEstimator(jm, optimizer=jopt.Adam(1e-2),
                      loss="sparse_categorical_crossentropy")
    te = Estimator(tm, optimizer=topt.Adam(1e-2),
                   loss="sparse_categorical_crossentropy",
                   ctx=ZooContext(ZooConf(seed=42, device="cpu")),
                   registry=MetricsRegistry())
    losses = {"jax": [], "port": []}
    je._listeners.append(lambda s, l: losses["jax"].append(float(l)))
    te._listeners.append(lambda s, l: losses["port"].append(float(l)))
    je.fit([enc, dec], y, batch_size=8, epochs=1, verbose=False)
    te.fit([enc, dec], y, batch_size=8, epochs=1, verbose=False)
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=TOL)
    want = jax.tree_util.tree_leaves_with_path(_np(je.params))
    got = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda t: t.numpy(), export_params(tm))))
    for path, leaf in want:
        np.testing.assert_allclose(got[path], leaf, atol=5e-5,
                                   err_msg=str(path))


# -- the batcher's bare-state lanes ------------------------------------------

GEN = dict(max_active_slots=3, max_tokens=10, max_prompt_len=24,
           stream_interval=0, decode_quantum=2, eos_id=None, start_id=1)
PKGS = {"jax": SimpleNamespace(gen=jgen, eng=jeng, q=jqueues, tc=jtc,
                               client=jclient),
        "port": SimpleNamespace(gen=tgen, eng=teng, q=tqueues, tc=ttc,
                                client=tclient)}


@pytest.fixture(scope="module")
def models():
    jm, tm, params = _pair((16,), "dense", seed=11)
    return {"jax": JaxIM().do_load_model(jm, params, {}),
            "port": InferenceModel(device="cpu").do_load_model(tm)}


def _reqs(n=9, seed=1, pmax=24, budgets=(1, 10)):
    g = np.random.default_rng(seed)
    return [(f"r{i}", g.integers(1, VOCAB, int(g.integers(2, pmax + 1)))
             .astype(np.int32), int(g.integers(budgets[0], budgets[1] + 1)))
            for i in range(n)]


def _drive(mod, b, reqs, resume=None):
    for rid, prompt, budget in reqs:
        assert b.submit(mod.GenRequest(
            rid, prompt, max_tokens=budget,
            resume_tokens=(resume or {}).get(rid), epoch=1 if resume
            else 0))
    done, events = {}, []
    for _ in range(1000):
        for ev in b.step():
            events.append(ev)
            assert ev.kind not in ("shed", "quarantine"), (ev.kind, ev.error)
            if ev.kind == "finish":
                done[ev.rid] = (list(ev.tokens), ev.finish_reason)
        if len(done) == len(reqs):
            return done, events
    raise AssertionError(f"stalled: {len(done)}/{len(reqs)} finished")


GEN_CASES = {
    "one_lane": GEN,
    "two_lanes_eos": dict(GEN, bucket_lens=[8, 64], eos_id=5),
    # a lane smaller than the biggest prompt bucket: bare state has no
    # length axis, so the lane holds any prompt and any budget
    "small_lane": dict(GEN, bucket_lens=[8], max_tokens=12),
    "quantum_1": dict(GEN, decode_quantum=1, max_active_slots=2),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
@pytest.mark.parametrize("warm", [False, True])
def test_batcher_serves_seq2seq_tokens_like_jax(models, case, warm):
    gen = GEN_CASES[case]
    out = {}   # tokens, event kinds, lanes, decode steps, program counts
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        b = mod.ContinuousBatcher(models[pkg], mod.GenerationParams(**gen))
        if warm:
            doc = b.warm()
            assert doc["failed"] == 0
        out[pkg] = (_drive(mod, b, _reqs(budgets=(1, gen["max_tokens"])))[0],
                    [e.kind for e in _drive(mod, b, _reqs(3, seed=9))[1]],
                    b.stats()["lanes"], b.decode_steps,
                    b.program_stats()["programs"])
    assert out["port"] == out["jax"]
    # every budget served in full: a bare-state lane does not clip it
    for rid, prompt, budget in _reqs(budgets=(1, gen["max_tokens"])):
        toks, reason = out["port"][0][rid]
        if reason == "length":
            assert len(toks) == budget


def test_batcher_tokens_are_each_requests_own_infer(models):
    """Every served row's tokens are its own ``Seq2seq.infer`` from
    ``start_id`` for its budget, whatever shares its admission batch and
    lane."""
    tm = models["port"]._model
    b = tgen.ContinuousBatcher(models["port"], tgen.GenerationParams(**GEN))
    reqs = _reqs(7, seed=4)
    done, _ = _drive(tgen, b, reqs)
    for rid, prompt, budget in reqs:
        want = tm.infer(prompt[None].astype(np.float32), start_sign=1,
                        max_seq_len=budget)[0]
        assert done[rid][0] == [int(t) for t in want], rid


def test_batcher_bare_state_manifest_stats_and_checkpoints(models):
    gen = dict(GEN, bucket_lens=[8], checkpoint_interval=2, resume=True)
    tb = tgen.ContinuousBatcher(models["port"], tgen.GenerationParams(**gen))
    jb = jgen.ContinuousBatcher(models["jax"], jgen.GenerationParams(**gen))
    assert tb.warmup_manifest() == jb.warmup_manifest()
    assert max(e.prefill_bucket or 0 for e in tb.warmup_manifest()) > 8
    _drive(tgen, tb, _reqs(4))
    assert tb.drain_checkpoints() == [] and tb.checkpoints == 0
    keys = ("can_resume", "checkpoints", "resumed", "resume_failed")
    assert {k: tb.stats()[k] for k in keys} == {
        "can_resume": False, "checkpoints": 0, "resumed": 0,
        "resume_failed": 0}
    assert {k: jb.stats()[k] for k in keys} == {k: tb.stats()[k]
                                                for k in keys}
    assert tb.state_bytes_doc()["lanes"] == 3 * 2 * 16 * 4


def test_batcher_bare_state_resume_is_downgraded_like_jax(models):
    """A request carrying resume tokens restarts from token 0 with the
    JAX ``resume_failed`` event (its reason, the wasted tokens), and its
    tokens equal an uninterrupted run's."""
    gen = dict(GEN, checkpoint_interval=2, resume=True)
    reqs = _reqs(3, seed=5)
    resume = {"r1": [4, 9, 2]}
    seen = {}
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        b = mod.ContinuousBatcher(models[pkg], mod.GenerationParams(**gen))
        done, events = _drive(mod, b, reqs, resume)
        fails = [(e.rid, e.error, list(e.tokens)) for e in events
                 if e.kind == "resume_failed"]
        seen[pkg] = (done, fails, b.stats()["resume_failed"],
                     b.stats()["resumed"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [
        ("r1", "bare-state model cannot replay decode state", [4, 9, 2])]
    plain = tgen.ContinuousBatcher(models["port"], tgen.GenerationParams(
        **GEN))
    assert _drive(tgen, plain, reqs)[0] == seen["port"][0]


def test_batcher_bare_state_paged_raises(models):
    with pytest.raises(NotImplementedError, match="paged"):
        tgen.ContinuousBatcher(models["port"], tgen.GenerationParams(
            **GEN, paged=True))
    with pytest.raises(ValueError, match="init_decode"):
        tgen.ContinuousBatcher(
            InferenceModel(device="cpu").do_load_model(torch.nn.Linear(2, 2)),
            tgen.GenerationParams(**GEN))


# -- the engine ---------------------------------------------------------------

def _enqueue(queue, rid, tokens, max_tokens=None):
    arr = np.ascontiguousarray(np.asarray(tokens, "<f4"))
    rec = {"uri": rid, "b64": base64.b64encode(arr).decode("ascii"),
           "dtype": "<f4", "shape": list(arr.shape)}
    if max_tokens is not None:
        rec["gen"] = {"max_tokens": int(max_tokens)}
    queue.xadd(rec)


def _golden(models, reqs):
    b = jgen.ContinuousBatcher(models["jax"], jgen.GenerationParams(**GEN))
    return {rid: toks for rid, (toks, _) in _drive(jgen, b, reqs)[0].items()}


def test_engine_serves_seq2seq_like_the_jax_batcher(models):
    """``ClusterServing`` in generation mode over ``InProcQueue``, warm-up
    on: every record's tokens equal the JAX batcher's; the warm-up
    document covers the bare-state manifest; health reports the lanes."""
    reqs = _reqs(8, seed=6)
    q = tqueues.InProcQueue()
    s = teng.ClusterServing(models["port"], q, teng.ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=GEN, warmup=True))
    s.start()
    try:
        for _ in range(600):
            if s.health()["warmup"]["state"] == "ready":
                break
            time.sleep(0.05)
        h = s.health()
        assert h["warmup"]["state"] == "ready" and \
            h["warmup"]["failed"] == 0
        for rid, prompt, budget in reqs:
            _enqueue(q, rid, prompt, budget)
        res = tclient.OutputQueue(q).query_many([r[0] for r in reqs],
                                                timeout_s=60.0)
        h = s.health()
    finally:
        s.shutdown(drain_s=2.0)
    want = _golden(models, reqs)
    for rid, _, budget in reqs:
        assert res[rid]["value"]["tokens"] == want[rid]
        assert res[rid]["value"]["length"] == budget
    gen = h["generation"]
    assert gen["finished"] == len(reqs) and gen["can_resume"] is False
    assert gen["checkpoints"] == 0


def test_engine_reclaims_a_bare_state_record_like_jax(models, tmp_path):
    """A record claimed by a dead owner, a checkpoint of it in the dead
    owner's spool and the lease annotation pointing there: both engines
    attach the snapshot (``gen_resume``), the batcher cannot replay it and
    restarts the record from 0 (``gen_resume_failed``, its wasted tokens);
    the client gets the uninterrupted tokens."""
    gen = dict(GEN, checkpoint_interval=2, resume=True)
    prompt = [5, 1, 8, 3]
    want = _golden(models, [("g", np.asarray(prompt, np.int32),
                             GEN["max_tokens"])])["g"]
    prefix = want[:4]
    seen = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        root = tmp_path / pkg
        root.mkdir()
        q = p.q.FileQueue(str(root / "q"))
        _enqueue(q, "r", prompt)
        q.consumer = "dead"
        assert [rid for rid, _ in q.read_batch(8, timeout_s=1.0)] == ["r"]
        assert q.put_partial("r", {"partial": True, "tokens": prefix,
                                   "n": len(prefix)})
        snap = {"rid": "r", "epoch": 0, "prompt": prompt, "tokens": prefix,
                "n": len(prefix), "tenant": None, "trace_id": None,
                "deadline_ns": None, "max_tokens": GEN["max_tokens"],
                "sampler": "greedy", "ts": time.monotonic()}
        snap["crc"] = p.tc.snapshot_checksum(snap)
        spool = str(root / "dead.gensnap.jsonl")
        p.tc.append_snapshots(spool, [snap], source="dead")
        q.annotate("r", {"spool": spool, "epoch": 0, "replica": "dead"})
        time.sleep(0.3)
        s = p.eng.ClusterServing(models[pkg], p.q.FileQueue(str(root / "q")),
                                 p.eng.ServingParams(
                                     max_batch=8, max_wait_ms=2.0,
                                     generation=gen, lease_s=0.2,
                                     reclaim_interval_s=0.05))
        s.snapshot_path = os.path.join(str(root), "survivor.gensnap.jsonl")
        s.start()
        try:
            res = p.client.OutputQueue(p.q.FileQueue(str(root / "q"))) \
                .query_many(["r"], timeout_s=60.0)
        finally:
            s.shutdown(drain_s=2.0)
        events = {name: [{k: e.get(k) for k in ("rid", "reason", "wasted",
                                                "resumed_tokens")}
                         for e in s.recorder.events()
                         if e.get("event") == name
                         and e.get("replica") == s.replica_id]
                  for name in ("gen_resume", "gen_resume_failed")}
        seen[pkg] = (res["r"]["value"]["tokens"], events,
                     s._batcher.stats()["resume_failed"])
    assert seen["port"] == seen["jax"]
    tokens, events, failed = seen["port"]
    assert tokens == want and failed == 1
    assert [e["rid"] for e in events["gen_resume"]] == ["r"]
    assert [e["rid"] for e in events["gen_resume_failed"]] == ["r"]
