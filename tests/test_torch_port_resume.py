"""PyTorch port: generation continuity against the JAX package on the CPU.

The same weights (the JAX param pytree, loaded with ``load_jax_params``)
and the same requests go through both packages, in monolithic lanes and in
paged lanes with f32 and int8 KV, with the continuity settings of the JAX
package's ``tests/test_generation_continuity.py`` (budget-only stopping,
checkpoints every 4 tokens, resume on).  Every comparison is exact:
tokens (greedy f32 at this size already matches the JAX batcher exactly),
counters, reasons, events and checksums.

- Checkpoints are collected at the interval and equal the JAX batcher's,
  apart from their timestamps.
- A resume from depth k = 4, 9 and 17 gives the JAX batcher's tokens; in
  monolithic and paged f32 lanes these are the uninterrupted tokens.
- Each downgrade to restart-from-0 names the JAX package's reason.
- Snapshot spools written by either package load in the other.
- The engine reclaims a dead owner's record (``FileQueue``,
  ``InProcQueue``) and resumes it to the JAX engine's tokens; a missing,
  corrupt, stale or unannotated snapshot restarts from 0 with the JAX
  engine's reasons and wasted counts.
- The fault points: ``FaultInjector`` equals the JAX package's point by
  point, ``decode_crash_after_n_tokens`` fires once across injectors,
  ``snapshot_corrupt`` leads to ``checksum-mismatch``.
- Every pool block comes back after a drain of mixed resumed and fresh
  requests.

- Usage is conserved across fresh and resumed slots: the resumed
  tenant is charged only the tokens past its checkpoint, the fresh one
  the full roll, as the JAX engine charges them.

Held elsewhere: the JAX file's bare-state test (the bare-state lanes are
in ``test_torch_port_seq2seq.py``) and its two-replica SIGKILL test behind
the load balancer (``test_torch_port_manager.py``).
"""

import base64
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import dtypes as jdtypes
from analytics_zoo_tpu.inference.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.textmodels import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import engine as jeng
from analytics_zoo_tpu.serving import faults as jfaults
from analytics_zoo_tpu.serving import generate as jgen
from analytics_zoo_tpu.serving import queues as jqueues
from analytics_zoo_tpu.serving import tracecollect as jtc
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import engine as teng
from analytics_zoo_tpu_torch.serving import faults as tfaults
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving import queues as tqueues
from analytics_zoo_tpu_torch.serving import tracecollect as ttc
from analytics_zoo_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

pytestmark = [pytest.mark.resume, pytest.mark.timeout(300)]

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = {"max_active_slots": 4, "max_tokens": 24, "eos_id": None,
       "max_prompt_len": 16, "stream_interval": 4, "decode_quantum": 4,
       "checkpoint_interval": 4, "resume": True}
LANES = {"mono": GEN,
         "paged": dict(GEN, paged=True, block_len=8),
         "int8": dict(GEN, paged=True, block_len=8, kv_quant="int8")}
PROMPT = [5, 1, 8, 3]
K = 9                                  # the engine tests' resume depth

PKGS = {"jax": SimpleNamespace(gen=jgen, eng=jeng, q=jqueues, tc=jtc,
                               client=jclient, faults=jfaults),
        "port": SimpleNamespace(gen=tgen, eng=teng, q=tqueues, tc=ttc,
                                client=tclient, faults=tfaults)}


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
    params = jlm.build(jax.random.PRNGKey(1))
    tlm = TransformerLM(**GEO, device="cpu")
    load_jax_params(tlm, jax.tree.map(np.asarray, params))
    return {"jax": JaxInferenceModel().do_load_model(jlm, params, {}),
            "port": InferenceModel(device="cpu").do_load_model(tlm)}


def _drive(b, max_steps=500):
    events = []
    for _ in range(max_steps):
        events.extend(b.step())
        if b.idle:
            return events
    raise AssertionError("scheduler did not quiesce")


def _finals(events):
    return {e.rid: e for e in events if e.kind == "finish"}


_GOLDEN = {}


@pytest.fixture(scope="module")
def golden(models):
    """The uninterrupted greedy rollout of ``PROMPT`` per (package, lane),
    the tokens a resume must reproduce."""
    def get(pkg, lane):
        key = (pkg, lane)
        if key not in _GOLDEN:
            mod = PKGS[pkg].gen
            b = mod.ContinuousBatcher(models[pkg],
                                      mod.GenerationParams(**LANES[lane]))
            b.submit(mod.GenRequest("g", np.asarray(PROMPT, np.float32)))
            _GOLDEN[key] = _finals(_drive(b))["g"].tokens
        return _GOLDEN[key]
    return get


def test_uninterrupted_tokens_match_jax(golden):
    for lane in LANES:
        assert golden("port", lane) == golden("jax", lane), lane
        assert len(golden("port", lane)) == GEN["max_tokens"]


# -- the batcher: checkpoints -------------------------------------------------

@pytest.mark.parametrize("lane", list(LANES))
def test_checkpoints_collected_on_interval_match_jax(models, lane):
    """Each active slot snapshots each time it accrues the interval, and
    the drained lists equal the JAX batcher's apart from ``ts``."""
    out = {}
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        b = mod.ContinuousBatcher(models[pkg],
                                  mod.GenerationParams(**LANES[lane]))
        b.submit(mod.GenRequest("a", np.asarray(PROMPT, np.float32),
                                tenant="acme", trace_id="t-1"))
        b.submit(mod.GenRequest("b", np.asarray([7, 7, 2, 9, 40, 11],
                                                np.float32), max_tokens=10))
        snaps = []
        for _ in range(200):
            b.step()
            snaps.extend(b.drain_checkpoints())
            assert b.pending_checkpoints == []
            if b.idle:
                break
        assert b.idle and b.checkpoints == len(snaps)
        assert b.stats()["checkpoints"] == len(snaps)
        out[pkg] = [{k: v for k, v in s.items() if k != "ts"}
                    for s in snaps]
    assert out["port"] == out["jax"]
    for rid in ("a", "b"):
        ns = [s["n"] for s in out["port"] if s["rid"] == rid]
        assert ns and ns == sorted(ns)
        assert all(b - a >= GEN["checkpoint_interval"]
                   for a, b in zip(ns, ns[1:]))
    a = [s for s in out["port"] if s["rid"] == "a"]
    assert all(s["prompt"] == PROMPT and len(s["tokens"]) == s["n"]
               and s["tenant"] == "acme" and s["trace_id"] == "t-1"
               and s["epoch"] == 0 and s["sampler"] == "greedy"
               for s in a)


# -- the batcher: resume --------------------------------------------------------

@pytest.mark.parametrize("k", [4, 9, 17])
@pytest.mark.parametrize("lane", list(LANES))
def test_resume_at_depth_matches_jax(models, golden, lane, k):
    """A resume from the depth-k prefix of the JAX package's uninterrupted
    rollout gives the JAX batcher's tokens.  In monolithic and paged f32
    lanes they are the uninterrupted tokens in both packages.  In int8
    lanes the JAX package quantizes a resume's blocks from the K/V of a
    prefill, not of decode, so its equality with the uninterrupted run is
    asserted only where it shows it; the port replays the prefix through
    decode and gives the uninterrupted tokens.  Every partial after the
    resume is a prefix of the final tokens and longer than k; the
    checkpoints carry the resumed epoch."""
    prefix = golden("jax", lane)[:k]
    got = {}
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        b = mod.ContinuousBatcher(models[pkg],
                                  mod.GenerationParams(**LANES[lane]))
        b.submit(mod.GenRequest("r", np.asarray(PROMPT, np.float32),
                                resume_tokens=list(prefix), epoch=1))
        events = []
        snaps = []
        for _ in range(200):
            events.extend(b.step())
            snaps.extend(b.drain_checkpoints())
            if b.idle:
                break
        final = _finals(events)["r"]
        assert final.finish_reason == "length"
        partials = [ev.tokens for ev in events if ev.kind == "partial"]
        assert partials
        for toks in partials:
            assert toks == final.tokens[:len(toks)] and len(toks) > k
        assert b.resumed == 1 and b.resume_failed == 0
        assert snaps and all(s["epoch"] == 1 for s in snaps)
        assert all(s["n"] > k for s in snaps)
        got[pkg] = final.tokens
    assert got["port"] == got["jax"] == golden("port", lane)
    if lane != "int8":
        assert got["jax"] == golden("jax", lane)


def _pool_after(pkg, models, lane, resume_tokens):
    """The int8 pool (codes and scales, every block but the trash block)
    after one request drains alone: uninterrupted, or resumed."""
    mod = PKGS[pkg].gen
    b = mod.ContinuousBatcher(models[pkg], mod.GenerationParams(**LANES[lane]))
    b.submit(mod.GenRequest("g", np.asarray(PROMPT, np.float32),
                            resume_tokens=resume_tokens, epoch=1))
    tokens = _finals(_drive(b))["g"].tokens
    pools = b._lanes[0].state
    return tokens, {part: [np.asarray(t)[1:] for t in pools[part]]
                    for part in ("k", "v", "ks", "vs")}


@pytest.mark.parametrize("k", [5, 9, 17])
def test_int8_resume_replays_decode_bitwise(models, golden, k):
    """Why the port's int8 resume replays its prefix through decode: int8
    K/V depends on the path that made it (decode attends over int8 K/V,
    prefill over exact K/V).  The port's resumed pool holds the codes and
    scales of the uninterrupted run, bit for bit; the JAX package's, which
    prefills over the prefix, does not, though its tokens agree at this
    size."""
    prefix = golden("jax", "int8")[:k]
    for pkg in ("port", "jax"):
        toks, want = _pool_after(pkg, models, "int8", None)
        got_toks, got = _pool_after(pkg, models, "int8", list(prefix))
        assert got_toks == toks
        same = all(np.array_equal(a, b) for part in want
                   for a, b in zip(want[part], got[part]))
        assert same == (pkg == "port"), pkg


def _downgrade_case(case, lane, prefix):
    """(generation settings, GenRequest keyword arguments) of one
    downgrade case."""
    gen = dict(LANES[lane])
    kw = dict(resume_tokens=list(prefix[:3]))
    if case == "malformed":
        kw["resume_tokens"] = [prefix[0], "x", prefix[1]]
    elif case == "vocab":
        kw["resume_tokens"] = [prefix[0], 4800]
    elif case == "budget":
        kw["max_tokens"] = 1
    elif case == "lane":
        # a prefill ladder whose bucket for the concatenation exceeds
        # every lane
        gen["prefill_buckets"] = [8, 16, 128]
        kw["resume_tokens"] = list(prefix[:20])
    elif case == "bucket":
        # no resume ladder: the concatenation has no prefill bucket
        gen["resume"] = False
        kw["resume_tokens"] = list(prefix[:20])
    return gen, kw


@pytest.mark.parametrize("case", ["malformed", "vocab", "budget", "lane",
                                  "bucket"])
@pytest.mark.parametrize("lane", ["mono", "paged"])
def test_resume_downgrades_match_jax(models, golden, lane, case):
    """Every resume prefix that cannot be replayed restarts from token 0
    with the JAX package's event: the same reason and wasted prefix
    (``resume_failed``), or, for a paged lane with no bucket for the
    concatenation, the same quarantine; the restart is counted."""
    prefix = golden("jax", lane)
    seen = {}
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        gen, kw = _downgrade_case(case, lane, prefix)
        b = mod.ContinuousBatcher(models[pkg], mod.GenerationParams(**gen))
        b.submit(mod.GenRequest("a", np.asarray(PROMPT, np.float32), **kw))
        events = _drive(b)
        seen[pkg] = ([(e.kind, e.error, e.tokens) for e in events
                      if e.kind in ("resume_failed", "quarantine")],
                     {k: v.tokens for k, v in _finals(events).items()},
                     (b.resumed, b.resume_failed, b.quarantined))
    assert seen["port"] == seen["jax"]
    fails, finals, (resumed, failed, quarantined) = seen["port"]
    assert resumed == 0 and len(fails) == 1
    if lane == "paged" and case == "bucket":
        assert fails[0][0] == "quarantine" and quarantined == 1
        return
    kind, reason, _ = fails[0]
    assert kind == "resume_failed" and failed == 1
    assert {"malformed": "malformed", "vocab": "vocab",
            "budget": "budget", "lane": "lane capacity",
            "bucket": "prefill bucket"}[case] in reason
    assert finals["a"] == prefix[:1 if case == "budget" else None]


# -- snapshot spools ------------------------------------------------------------

def _snaps(seed=0, n=5):
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = [int(t) for t in g.integers(0, 50257, int(g.integers(1, 40)))]
        out.append({"rid": f"r{i}", "epoch": int(g.integers(0, 3)),
                    "prompt": [int(t) for t in g.integers(0, 50257, 7)],
                    "tokens": toks, "n": len(toks), "tenant": None,
                    "trace_id": f"t{i}", "deadline_ns": None,
                    "max_tokens": 64, "sampler": "greedy",
                    "ts": time.monotonic()})
    return out


def test_spool_written_by_either_package_loads_in_the_other(tmp_path):
    """The checksum agrees bit for bit, and a spool written by one package
    loads in the other to the same records."""
    recs = _snaps()
    for rec in recs:
        rec["crc"] = ttc.snapshot_checksum(rec)
        assert rec["crc"] == jtc.snapshot_checksum(rec)
    written = {"port": str(tmp_path / "port.gensnap.jsonl"),
               "jax": str(tmp_path / "jax.gensnap.jsonl")}
    assert ttc.append_snapshots(written["port"], recs, source="p") == 5
    assert jtc.append_snapshots(written["jax"], recs, source="j") == 5
    for pkg, path in written.items():
        a, b = ttc.load_snapshots([path]), jtc.load_snapshots([path])
        assert a == b and len(a) == len(recs), pkg
        for rec in a:
            assert int(rec["crc"]) == ttc.snapshot_checksum(rec) \
                == jtc.snapshot_checksum(rec)
            assert "clock_skewed" not in rec
    assert ttc.gensnap_path("x.pid") == jtc.gensnap_path("x.pid")


def test_spool_rotation_and_discovery_match_jax(tmp_path):
    for pkg, tc in (("jax", jtc), ("port", ttc)):
        base = str(tmp_path / f"{pkg}.pid")
        path = tc.gensnap_path(base + ".r0")
        for i in range(3):
            tc.append_snapshots(path, _snaps(seed=i, n=2), max_bytes=64)
        tc.append_snapshots(tc.gensnap_path(base + ".r1"), _snaps(n=1))
        assert os.path.exists(path + ".1")
        found = tc.find_snapshot_spools(base)
        assert [os.path.basename(p).replace(pkg, "")
                for p in found] == [".pid.r0.gensnap.jsonl",
                                    ".pid.r0.gensnap.jsonl.1",
                                    ".pid.r1.gensnap.jsonl"]
    assert ([r["rid"] for r in ttc.load_snapshots(
        ttc.find_snapshot_spools(str(tmp_path / "jax.pid")))]
        == [r["rid"] for r in jtc.load_snapshots(
            jtc.find_snapshot_spools(str(tmp_path / "jax.pid")))])


# -- the engine: reclaim and resume ----------------------------------------------

def _queue(pkg, kind, root):
    q = PKGS[pkg].q
    return q.InProcQueue() if kind == "inproc" else q.FileQueue(str(root))


def _handle(pkg, kind, queue, root):
    """Another handle on the same queue (a second process would open one)."""
    return queue if kind == "inproc" else PKGS[pkg].q.FileQueue(str(root))


def _enqueue(queue, rid, tokens, tenant=None, trace_id=None):
    arr = np.ascontiguousarray(np.asarray(tokens, "<f4"))
    rec = {"uri": rid, "b64": base64.b64encode(arr).decode("ascii"),
           "dtype": "<f4", "shape": list(arr.shape)}
    if tenant is not None:
        rec["tenant"] = tenant
    if trace_id is not None:
        rec["trace_id"] = trace_id
    queue.xadd(rec)


def _claim_dead(queue, n):
    """Claim every queued record as consumer "dead" (never acked)."""
    queue.consumer = "dead"
    claimed = queue.read_batch(8, timeout_s=1.0)
    assert len(claimed) == n, claimed
    return [rid for rid, _ in claimed]


def _snapshot(pkg, rid, tokens, epoch=0, corrupt=False):
    snap = {"rid": rid, "epoch": epoch, "prompt": list(PROMPT),
            "tokens": [int(t) for t in tokens], "n": len(tokens),
            "tenant": None, "trace_id": None, "deadline_ns": None,
            "max_tokens": GEN["max_tokens"], "sampler": "greedy",
            "ts": time.monotonic()}
    snap["crc"] = PKGS[pkg].tc.snapshot_checksum(snap) ^ (
        0x5A5A5A5A if corrupt else 0)
    return snap


def _survivor(pkg, models, queue, root, gen):
    p = PKGS[pkg]
    s = p.eng.ClusterServing(models[pkg], queue, p.eng.ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=gen, lease_s=0.2,
        reclaim_interval_s=0.05))
    s.snapshot_path = os.path.join(str(root), "survivor.gensnap.jsonl")
    return s


def _serve(pkg, s, queue, rids, timeout_s=90.0):
    s.start()
    try:
        return PKGS[pkg].client.OutputQueue(queue).query_many(
            rids, timeout_s=timeout_s)
    finally:
        s.shutdown(drain_s=2.0)


def _events(s, name):
    return [e for e in s.recorder.events()
            if e.get("event") == name and e.get("replica") == s.replica_id]


def _counter(s, name):
    return s.registry.snapshot()[name]["values"][0]["value"]


@pytest.mark.parametrize("lane", ["mono", "paged"])
@pytest.mark.parametrize("kind", ["inproc", "file"])
def test_engine_reclaims_and_resumes_dead_owner_like_jax(
        models, golden, kind, lane, tmp_path):
    """A record claimed by a dead owner — its streamed partial in the
    result store, a depth-9 checkpoint in its spool, the lease annotation
    pointing there — is reclaimed and resumed: the terminal equals the JAX
    engine's (and the uninterrupted tokens), one ``gen_resume`` event with
    the JAX engine's fields, the resumed counter at 1 and no waste."""
    gen = LANES[lane]
    prefix = golden("jax", lane)[:K]
    seen = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        q = _queue(pkg, kind, root / "q")
        _enqueue(q, "r", PROMPT, tenant="acme", trace_id="t-chaos")
        assert _claim_dead(q, 1) == ["r"]
        assert q.put_partial("r", {"partial": True, "tokens": prefix,
                                   "n": K})
        spool = str(root / "dead.gensnap.jsonl")
        PKGS[pkg].tc.append_snapshots(spool, [_snapshot(pkg, "r", prefix)],
                                      source="dead")
        q.annotate("r", {"spool": spool, "epoch": 0, "replica": "dead"})
        _enqueue(_handle(pkg, kind, q, root / "q"), "fresh", PROMPT,
                 tenant="zeta")
        time.sleep(0.3)                      # the dead claim goes stale
        s = _survivor(pkg, models, _handle(pkg, kind, q, root / "q"), root,
                      gen)
        res = _serve(pkg, s, _handle(pkg, kind, q, root / "q"),
                     ["r", "fresh"])
        ev = [{k: e.get(k) for k in ("rid", "resumed_tokens", "wasted",
                                     "from_replica", "epoch", "trace_id")}
              for e in _events(s, "gen_resume")]
        h = s.health()["generation"]
        seen[pkg] = (res["r"]["value"]["tokens"],
                     res["fresh"]["value"]["tokens"],
                     bool(res["r"].get("partial")), ev,
                     _counter(s, "serving_generations_resumed_total"),
                     _counter(s, "serving_resume_wasted_tokens_total"),
                     h["resumed"], h["snapshot_bytes"] > 0)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == (golden("port", lane), golden("port", lane),
                            False,
                            [{"rid": "r", "resumed_tokens": K, "wasted": 0,
                              "from_replica": "dead", "epoch": 0,
                              "trace_id": "t-chaos"}],
                            1.0, 0.0, 1, True)


def test_engine_resume_failures_restart_from_zero_like_jax(
        models, golden, tmp_path):
    """A corrupt checkpoint, a missing spool, a checkpoint of another
    epoch and a record without annotation each restart from 0 with the
    JAX engine's reason, the streamed partial counted as waste; the
    client still gets the uninterrupted tokens."""
    rids = ("corrupt", "missing", "stale", "noann")
    prefix = golden("jax", "mono")[:K]
    seen = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        q = _queue(pkg, "file", root / "q")
        for rid in rids:
            _enqueue(q, rid, PROMPT)
        _claim_dead(q, len(rids))
        for rid in rids:
            assert q.put_partial(rid, {"partial": True, "tokens": prefix,
                                       "n": K})
        spool = str(root / "dead.gensnap.jsonl")
        PKGS[pkg].tc.append_snapshots(spool, [
            _snapshot(pkg, "corrupt", prefix, corrupt=True),
            _snapshot(pkg, "stale", prefix, epoch=3)], source="dead")
        q.annotate("corrupt", {"spool": spool, "epoch": 0,
                               "replica": "dead"})
        q.annotate("stale", {"spool": spool, "epoch": 0, "replica": "dead"})
        q.annotate("missing", {"spool": str(root / "gone.gensnap.jsonl"),
                               "epoch": 0, "replica": "dead"})
        time.sleep(0.3)
        s = _survivor(pkg, models, _handle(pkg, "file", q, root / "q"),
                      root, GEN)
        res = _serve(pkg, s, _handle(pkg, "file", q, root / "q"),
                     list(rids))
        seen[pkg] = ({rid: res[rid]["value"]["tokens"] for rid in rids},
                     {e["rid"]: (e["reason"], e["wasted"])
                      for e in _events(s, "gen_resume_failed")},
                     s._batcher.stats()["resumed"],
                     _counter(s, "serving_resume_wasted_tokens_total"))
    assert seen["port"] == seen["jax"]
    tokens, fails, resumed, wasted = seen["port"]
    assert all(t == golden("port", "mono") for t in tokens.values())
    assert fails == {"corrupt": ("checksum-mismatch", K),
                     "missing": ("no-snapshot", K),
                     "stale": ("no-snapshot", K),
                     "noann": ("no-annotation", K)}
    assert resumed == 0 and wasted == 4.0 * K


# -- fault points -----------------------------------------------------------------

FAULT_SPECS = {
    "predict_error": {"version": "v2", "after": 2},
    "predict_slow": {"version": "*", "ms": 1},
    "warmup_crash": {"version": "v3"},
    "readyz_delay": {"version": "*", "seconds": 10},
    "claim_stall": {"version": "*", "seconds": 0.25, "count": 2},
    "admission_reject": {"version": "*", "count": 3,
                         "priority": "best_effort"},
    "decode_crash_after_n_tokens": {"version": "*", "n": 10},
    "snapshot_corrupt": {"version": "v2"},
}


def _injector_doc(fi, tmp):
    """Everything observable of an injector, its take_* budgets spent."""
    doc = {"describe": fi.describe(),
           "active": [fi.predict_active, fi.readyz_active, fi.claim_active,
                      fi.admission_active, fi.decode_crash_active,
                      fi.snapshot_corrupt_active, fi.any_active],
           "claim": [fi.take_claim_stall() for _ in range(4)],
           "admission": [fi.take_admission_reject(p) for p in
                         ("interactive", "best_effort", None, "best_effort",
                          "best_effort", None)],
           "crash": [fi.take_decode_crash(n) for n in (0, 9, 10, 11)],
           "readyz": [fi.readyz_block_reason(t) for t in (0.0, 9.5, 10.0)]}
    calls = []
    wrapped = fi.wrap_predict(lambda x, scales=None: ("ok", scales))
    for i in range(4):
        try:
            calls.append(wrapped(i, scales=i))
        except RuntimeError as e:
            calls.append((type(e).__name__, str(e)))
    doc["predict"] = calls
    return doc


@pytest.mark.parametrize("version", ["v2", "v3", None])
@pytest.mark.parametrize("point", list(FAULT_SPECS) + ["all", "none"])
def test_fault_injector_matches_jax(point, version, tmp_path):
    """``describe()``, the armed flags, every ``take_*`` sequence, the
    readiness reason and the predict wrapper equal the JAX package's, for
    every fault point, under version gating."""
    spec = (dict(FAULT_SPECS) if point == "all" else
            {} if point == "none" else {point: FAULT_SPECS[point]})
    docs = [_injector_doc(p.faults.FaultInjector(spec, version), tmp_path)
            for p in (PKGS["jax"], PKGS["port"])]
    assert docs[0] == docs[1]
    assert issubclass(tfaults.FaultError, RuntimeError)


def test_decode_crash_fault_is_exactly_once(tmp_path):
    """``decode_crash_after_n_tokens`` fires only past n tokens, and its
    ``once`` marker is an atomic claim: a second injector (a respawned
    process) with the same config never fires; the JAX package's injector
    sees the same marker the same way."""
    marker = str(tmp_path / "crash.marker")
    spec = {"decode_crash_after_n_tokens":
            {"version": "*", "n": 10, "once": marker}}
    fi = tfaults.FaultInjector(spec, "v1")
    assert fi.decode_crash_active and fi.any_active
    assert fi.describe() == ["decode_crash_after_n_tokens"]
    assert not fi.take_decode_crash(9)
    assert not os.path.exists(marker)
    assert fi.take_decode_crash(10)
    assert os.path.exists(marker)
    assert not fi.take_decode_crash(11)
    assert not tfaults.FaultInjector(spec, "v1").take_decode_crash(999)
    assert not jfaults.FaultInjector(spec, "v1").take_decode_crash(999)
    os.remove(marker)
    assert jfaults.FaultInjector(spec, "v1").take_decode_crash(10)
    assert not tfaults.FaultInjector(spec, "v1").take_decode_crash(10)
    gated = tfaults.FaultInjector({"decode_crash_after_n_tokens":
                                   {"version": "v2", "n": 1}}, "v1")
    assert not gated.decode_crash_active


def test_snapshot_corrupt_fault_leads_to_checksum_mismatch(
        models, golden, tmp_path):
    """An engine with ``snapshot_corrupt`` armed writes checkpoints whose
    crc fails (in both packages' checksum); a survivor pointed at its
    deepest one restarts from 0 with ``checksum-mismatch``."""
    q = tqueues.FileQueue(str(tmp_path / "q1"))
    _enqueue(q, "r", PROMPT)
    victim = teng.ClusterServing(
        models["port"], tqueues.FileQueue(str(tmp_path / "q1")),
        teng.ServingParams(max_batch=8, max_wait_ms=2.0, generation=GEN,
                           faults={"snapshot_corrupt": {"version": "*"}}))
    assert victim.health()["faults"] == ["snapshot_corrupt"]
    victim.snapshot_path = str(tmp_path / "victim.gensnap.jsonl")
    res = _serve("port", victim, q, ["r"])
    assert res["r"]["value"]["tokens"] == golden("port", "mono")
    snaps = ttc.load_snapshots([victim.snapshot_path])
    assert len(snaps) == (GEN["max_tokens"] - 1) // 4
    for s in snaps:
        assert int(s["crc"]) != ttc.snapshot_checksum(s)
        assert int(s["crc"]) != jtc.snapshot_checksum(s)
    q2 = tqueues.FileQueue(str(tmp_path / "q2"))
    _enqueue(q2, "r2", PROMPT)
    _claim_dead(q2, 1)
    spool = str(tmp_path / "dead.gensnap.jsonl")
    ttc.append_snapshots(spool, [dict(max(snaps, key=lambda s: s["n"]),
                                      rid="r2")], source="dead")
    q2.annotate("r2", {"spool": spool, "epoch": 0, "replica": "dead"})
    time.sleep(0.3)
    s = _survivor("port", models, tqueues.FileQueue(str(tmp_path / "q2")),
                  tmp_path, GEN)
    res = _serve("port", s, q2, ["r2"])
    assert res["r2"]["value"]["tokens"] == golden("port", "mono")
    assert [e["reason"] for e in _events(s, "gen_resume_failed")] == \
        ["checksum-mismatch"]


def test_admission_reject_fault_raises_in_the_port_engine(models):
    """An armed ``admission_reject`` point fires in the admission gate, as
    in the JAX engine: the next ``count`` requests are rejected with
    reason "fault" (the point shows in ``health()``), then it disarms;
    gated off by version, it never fires."""
    seen = {}
    for pkg in ("jax", "port"):
        eng = PKGS[pkg].eng
        s = eng.ClusterServing(models[pkg], PKGS[pkg].q.InProcQueue(),
                               eng.ServingParams(
                                   generation=GEN, admission={},
                                   faults={"admission_reject": {
                                       "version": "*", "count": 2}}))
        off = eng.ClusterServing(models[pkg], PKGS[pkg].q.InProcQueue(),
                                 eng.ServingParams(
                                     generation=GEN, admission={},
                                     faults={"admission_reject": {
                                         "version": "v9"}}))
        seen[pkg] = ([tuple(s.admit_record("acme", "batch"))
                      for _ in range(3)], s.health()["faults"],
                     [e["reason"] for e in _events(s, "admission_reject")],
                     off.admit_record("acme", "batch").admitted,
                     "faults" in off.health())
        s.shutdown()
        off.shutdown()
    assert seen["port"] == seen["jax"]
    assert [d[:2] for d in seen["port"][0]] == [
        (False, "fault"), (False, "fault"), (True, None)]
    assert seen["port"][1:] == (["admission_reject"], ["fault", "fault"],
                                True, False)


@pytest.mark.parametrize("lane", ["mono", "paged"])
def test_usage_conserved_across_fresh_and_resumed_slots_like_jax(
        models, golden, lane, tmp_path):
    """A resumed record (tenant acme, checkpoint at depth K) and a fresh
    one (tenant zeta) served together: the same tokens and the same usage
    as the JAX engine — the resumed tenant charged only the tokens past
    its checkpoint, the fresh one the full roll, each less the prefill's
    first token, which both packages charge outside the boundary deltas —
    and no journal delta negative across the resume epoch."""
    gen = LANES[lane]
    prefix = golden("jax", lane)[:K]
    seen = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        q = _queue(pkg, "inproc", root / "q")
        _enqueue(q, "r", PROMPT, tenant="acme")
        assert _claim_dead(q, 1) == ["r"]
        spool = str(root / "dead.gensnap.jsonl")
        PKGS[pkg].tc.append_snapshots(spool, [_snapshot(pkg, "r", prefix)],
                                      source="dead")
        q.annotate("r", {"spool": spool, "epoch": 0, "replica": "dead"})
        _enqueue(q, "fresh", PROMPT, tenant="zeta")
        time.sleep(0.3)                      # the dead claim goes stale
        s = _survivor(pkg, models, q, root, gen)
        res = _serve(pkg, s, q, ["r", "fresh"])
        tenants = s.meter.snapshot()["tenants"]
        drained = s.meter.drain()
        seen[pkg] = (res["r"]["value"]["tokens"],
                     res["fresh"]["value"]["tokens"],
                     {t: (d["records"], d["tokens"], d["sheds"])
                      for t, d in tenants.items()},
                     all(r[f] >= 0 for r in drained
                         for f in ("records", "tokens", "device_s",
                                   "bytes", "sheds")))
    assert seen["port"] == seen["jax"]
    n = len(golden("port", lane))
    assert seen["port"][2] == {"acme": (1, n - K - 1, 0),
                               "zeta": (1, n - 1, 0)}
    assert seen["port"][3]


def test_engine_fault_hooks_are_wired():
    """The predict wrapper raises through the model the engine serves; an
    armed readiness delay holds readiness and shows in ``health()``; an
    armed claim stall stalls the read loop once per count."""
    im = InferenceModel(device="cpu").do_load_model(
        Sequential([tcore.Dense(3, input_shape=(4,), name="d")]))
    s = teng.ClusterServing(im, tqueues.InProcQueue(), teng.ServingParams(
        model_version="v2", faults={
            "predict_error": {"version": "v2", "after": 1},
            "readyz_delay": {"version": "*", "seconds": 60},
            "claim_stall": {"version": "v2", "seconds": 0.01,
                            "count": 1}}))
    x = np.zeros((2, 4), np.float32)
    assert im.do_predict(x).shape == (2, 3)
    with pytest.raises(tfaults.FaultError, match="version v2, call #2"):
        im.do_predict(x)
    h = s.health()
    assert h["faults"] == ["predict_error", "readyz_delay", "claim_stall"]
    assert any(r.startswith("fault-injected readyz_delay")
               for r in h["ready"]["reasons"])
    t0 = time.monotonic()
    assert s._read_and_preprocess() is None
    assert time.monotonic() - t0 >= 0.01
    assert s._faults.take_claim_stall() == 0.0
    s.shutdown()


# -- block accounting -------------------------------------------------------------

@pytest.mark.parametrize("lane", ["paged", "int8"])
def test_pool_blocks_return_after_mixed_resume_drain(models, golden, lane):
    """Fresh and resumed requests (depths across block edges, one sharing
    the resumed prompt's prefix) drain in one pool: the tokens equal the
    JAX batcher's, the blocks held at every boundary too in the f32 lane
    (an int8 resume replays its prefix through decode in the port, so it
    holds its slot longer and registers only its prompt), and every block
    comes back once the prefix cache lets go of its own."""
    g = golden("jax", lane)
    reqs = [("f0", PROMPT, None), ("r1", PROMPT, g[:1]),
            ("r8", PROMPT, g[:8]), ("f1", [9, 4, 4, 30, 2, 2, 7, 1, 3], None),
            ("r17", PROMPT, g[:17]), ("f2", PROMPT + g[:12], None),
            ("r23", PROMPT, g[:23])]
    got = {}
    for pkg in ("jax", "port"):
        mod = PKGS[pkg].gen
        b = mod.ContinuousBatcher(models[pkg],
                                  mod.GenerationParams(**LANES[lane]))
        for rid, prompt, rt in reqs:
            assert b.submit(mod.GenRequest(
                rid, np.asarray(prompt, np.float32),
                resume_tokens=None if rt is None else list(rt), epoch=1))
        events, used = [], []
        while not b.idle:
            events.extend(b.step())
            used.append(b.stats()["pool"]["used_blocks"])
        got[pkg] = ({k: v.tokens for k, v in _finals(events).items()},
                    used)
        assert b.resumed == 4 and b.resume_failed == 0
        assert b.active == 0
        if pkg == "port":
            pool = b.stats()["pool"]
            assert pool["free_blocks"] < pool["blocks"]
            b._prefix.evict_for(b._pool.n_blocks)
            pool = b.stats()["pool"]
            assert pool["free_blocks"] == pool["blocks"], pool
    assert got["port"][0] == got["jax"][0] and len(got["port"][0]) == len(reqs)
    if lane == "paged":
        assert got["port"][1] == got["jax"][1]
