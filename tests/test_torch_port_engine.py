"""PyTorch port: ``ClusterServing`` in generation mode, end to end on the CPU.

Records go in through the client over ``InProcQueue``; the engine's
workers read, decode and hand them to the paged batcher; terminal results,
streamed partials, a quarantined poison record and a shed late record come
back under the queue's contracts (the shape of the JAX package's
``test_engine_generation_e2e_streaming``).  The served tokens must equal a
direct run of the port's batcher over the same prompts.
"""

import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.serving import generate as tgen
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import (ClusterServing,
                                                    ServingParams)
from analytics_zoo_tpu_torch.serving.queues import InProcQueue

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

GEO = dict(vocab_size=48, hidden=32, n_head=4, n_layers=2, max_len=64)
GEN = dict(paged=True, block_len=8, max_active_slots=4, max_tokens=12,
           max_prompt_len=16, stream_interval=2, decode_quantum=2,
           kv_quant="off")


class _PartialLog(InProcQueue):
    """InProcQueue that remembers every streamed partial."""

    def __init__(self):
        super().__init__()
        self.partials = {}

    def put_partial(self, rid, value):
        self.partials.setdefault(rid, []).append(list(value["tokens"]))
        return super().put_partial(rid, value)


def _im():
    return InferenceModel(device="cpu").do_load_model(
        TransformerLM(**GEO, seed=3, device="cpu"))


PROMPTS = {"a": [3, 9, 27, 4, 12],
           "b": list(range(1, 17)),
           "c": [40, 41]}


def test_engine_generation_e2e_streaming_and_quarantine():
    im = _im()
    q = _PartialLog()
    serving = ClusterServing(im, q, ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=GEN))
    iq, oq = InputQueue(q), OutputQueue(q)
    serving.start()
    try:
        for rid, p in PROMPTS.items():
            iq.enqueue_tensor(rid, np.asarray(p, np.float32))
        iq.enqueue_tensor("poison", np.asarray([1, 10_000], np.float32))
        q.xadd({"uri": "late", "data": [1.0, 2.0],
                "deadline_ns": time.time_ns() - int(1e9)})
        res = oq.query_many(list(PROMPTS) + ["poison", "late"],
                            timeout_s=60.0)
        # the engine keeps serving after the quarantine
        iq.enqueue_tensor("after", np.asarray([7, 8, 9], np.float32))
        after = oq.query("after", timeout_s=60.0)
        snap = serving.registry.snapshot()
        h = serving.health()
    finally:
        serving.shutdown(drain_s=2.0)

    ref = tgen.ContinuousBatcher(im, tgen.GenerationParams(**GEN))
    for rid, p in list(PROMPTS.items()) + [("after", [7, 8, 9])]:
        ref.submit(tgen.GenRequest(rid, np.asarray(p, np.float32)))
    want = {}
    while not ref.idle:
        for ev in ref.step():
            if ev.kind == "finish":
                want[ev.rid] = ev.tokens
    res["after"] = after
    for rid in list(PROMPTS) + ["after"]:
        r = res[rid]
        assert not OutputQueue.is_partial(r) and "value" in r, r
        assert r["value"]["tokens"] == want[rid]
        assert r["value"]["length"] == GEN["max_tokens"]
        assert r["value"]["finish_reason"] == "length"
        # partials streamed every 2 tokens, each a prefix of the final
        parts = q.partials[rid]
        assert [len(p) for p in parts] == list(
            range(2, GEN["max_tokens"], 2))
        for p in parts:
            assert p == want[rid][:len(p)]
    assert OutputQueue.is_error(res["poison"])
    assert "out of range" in res["poison"]["error"]
    assert OutputQueue.is_deadline_exceeded(res["late"])
    assert "poison" in {e["uri"] for e in q.dead_letters()}
    assert serving.dead_lettered == 1 and serving.shed == 1
    assert serving.total_records == 4
    n_tok = 4 * GEN["max_tokens"]
    assert serving._batcher.generated_tokens == n_tok
    # metering is on by default: tokens are charged to the records' tenant
    # ("unknown" here) at each decode boundary, which leaves out the token
    # each request's prefill emits, as the JAX engine's meter does
    tok = snap["serving_generated_tokens_total"]["values"]
    assert [(v["labels"], v["value"]) for v in tok] == [
        ({"tenant": "unknown", "model": "default"}, n_tok - 4)]
    assert snap["serving_decode_steps_total"]["values"][0]["value"] > 0
    assert snap["serving_time_to_first_token_seconds"]["values"][0][
        "count"] == 4
    gen = h["generation"]
    assert gen["finished"] == 4 and gen["quarantined"] == 1
    assert gen["slots_total"] == GEN["max_active_slots"]
    assert h["device"] == "cpu"


def test_engine_serve_once_synchronous_drive():
    im = _im()
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(generation=dict(
        GEN, kv_quant="int8")))
    iq = InputQueue(q)
    for rid, p in PROMPTS.items():
        iq.enqueue_tensor(rid, np.asarray(p, np.float32))
    assert serving.serve_once() == len(PROMPTS)
    res = q.get_results(list(PROMPTS))
    assert all(r["value"]["length"] == GEN["max_tokens"]
               for r in res.values())
    assert serving._batcher.stats()["pool"]["kv_quant"] == "int8"
    serving.shutdown()


@pytest.mark.parametrize("opt", [dict(mesh_shape=(1, 2), generation=GEN),
                                 dict(compile_cache_dir="xla-cache",
                                      generation=GEN),
                                 dict(sharding="auto"),
                                 dict(sharding="batch", generation=GEN)])
def test_engine_unported_options_raise(opt):
    """The options of the JAX engine that the port does not serve yet
    (sharding waits for multi-GPU; XLA's compilation cache has no
    counterpart) raise rather than being dropped."""
    with pytest.raises(NotImplementedError):
        ClusterServing(_im(), InProcQueue(), ServingParams(**opt))


def test_engine_predict_plane_options_are_served():
    """The predict plane and its options (top_n, filter_threshold,
    inflight_batches, quantize) construct; a generation engine accepts
    them too, as the JAX engine does."""
    for opt in (dict(generation=None, top_n=3, inflight_batches=4),
                dict(top_n=3, filter_threshold=0.5, generation=GEN)):
        serving = ClusterServing(_im(), InProcQueue(), ServingParams(**opt))
        assert (serving._batcher is None) == (opt["generation"] is None)
        serving.shutdown()


def test_engine_params_take_the_reference_defaults():
    """A config written for the JAX engine, with its predict-plane and
    gateway options left at their defaults, is accepted; an unknown option
    is an error."""
    p = ServingParams.from_dict({"top_n": 5, "inflight_batches": 2,
                                 "gateway": True, "sharding": "off",
                                 "generation": GEN})
    assert p.generation == GEN
    with pytest.raises(TypeError):
        ServingParams(no_such_option=1)


MONO = dict(paged=False, bucket_lens=[32, 64], max_active_slots=2,
            max_tokens=12, max_prompt_len=16, stream_interval=0,
            decode_quantum=2)


def _wait_warm(serving, timeout_s=60.0):
    t0 = time.monotonic()
    while serving.health()["warmup"]["state"] in ("pending", "warming"):
        assert time.monotonic() - t0 < timeout_s, serving.health()["warmup"]
        time.sleep(0.01)
    return serving.health()


@pytest.mark.parametrize("gen", [MONO, GEN])
def test_engine_warms_then_serves(gen):
    """``warmup=True``: the batcher's manifest is warmed on the warm-up
    thread, readiness waits for it, and the engine then serves the same
    tokens as a direct run of an unwarmed batcher; ``paged=False`` serves
    through monolithic lanes."""
    im = _im()
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(
        max_batch=8, max_wait_ms=2.0, generation=gen, warmup=True))
    manifest = serving._batcher.warmup_manifest()
    assert serving.health()["warmup"]["state"] == "off"
    serving.start()
    try:
        first = serving.ready()
        h = _wait_warm(serving)
        w = h["warmup"]
        assert w["state"] == "ready" and w["failed"] == 0
        assert w["total"] == w["compiled"] == len(manifest)
        assert w["compile_stats"]["captures"] == 0     # no graphs on a CPU
        assert h["ready"]["ready"], h["ready"]
        assert serving.ready()["warmup"]["state"] == "ready"
        if first["warmup"]["state"] in ("pending", "warming"):
            assert any(r.startswith("warming") for r in first["reasons"])
        iq, oq = InputQueue(q), OutputQueue(q)
        for rid, p in PROMPTS.items():
            iq.enqueue_tensor(rid, np.asarray(p, np.float32))
        res = oq.query_many(list(PROMPTS), timeout_s=60.0)
        snap = serving.registry.snapshot()
    finally:
        serving.shutdown(drain_s=2.0)
    assert serving._warm_thread is not None \
        and not serving._warm_thread.is_alive()
    assert snap["serving_warmup_seconds"]["values"]
    ref = tgen.ContinuousBatcher(im, tgen.GenerationParams(**gen))
    for rid, p in PROMPTS.items():
        ref.submit(tgen.GenRequest(rid, np.asarray(p, np.float32)))
    want = {}
    while not ref.idle:
        for ev in ref.step():
            if ev.kind == "finish":
                want[ev.rid] = ev.tokens
    for rid in PROMPTS:
        assert res[rid]["value"]["tokens"] == want[rid], rid
    st = serving._batcher.stats()
    assert st["finished"] == len(PROMPTS) and st["captures"] == 0
    assert ("pool" in st) == gen["paged"]
    assert len(st["lanes"]) == (1 if gen["paged"] else 2)


def test_serving_params_positional_order_matches_jax(tmp_path):
    """Positional arguments mean the same thing in both packages: every
    positional slot the two ``ServingParams`` and the two
    ``ClusterServing`` constructors share carries the same name, and
    ``ServingParams(4, 5, 0.05, 1000)`` trims the stream at 1000 in both.
    ``tensorboard_dir``, the sixth slot, writes the predict plane's
    ``Serving Throughput`` and ``Total Records Number`` scalars, as the
    JAX engine does."""
    import inspect

    from analytics_zoo_tpu.serving import engine as jeng

    def slots(fn):
        return [n for n, p in inspect.signature(fn).parameters.items()
                if n != "self" and p.kind in (p.POSITIONAL_ONLY,
                                              p.POSITIONAL_OR_KEYWORD)]

    for jfn, tfn in ((jeng.ServingParams.__init__, ServingParams.__init__),
                     (jeng.ClusterServing.__init__,
                      ClusterServing.__init__)):
        js, ts = slots(jfn), slots(tfn)
        shared = min(len(js), len(ts))
        assert shared == len(js) and ts[:shared] == js[:shared], (js, ts)
    args = (4, 5, 0.05, 1000, 0.25)
    j, t = jeng.ServingParams(*args), ServingParams(*args)
    for name in ("batch_size", "top_n", "poll_timeout_s", "stream_max_len",
                 "filter_threshold"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.stream_max_len == 1000
    from analytics_zoo_tpu_torch.nn.layers.core import Dense
    from analytics_zoo_tpu_torch.nn.models import Sequential
    from analytics_zoo_tpu_torch.serving.engine import default_preprocess
    from analytics_zoo_tpu_torch.utils.tbwriter import read_scalars
    tb = str(tmp_path / "tb-logs")
    im = InferenceModel(device="cpu").do_load_model(
        Sequential([Dense(4, input_shape=(3,), activation="softmax")]))
    q = InProcQueue()
    serving = ClusterServing(im, q, ServingParams(), default_preprocess,
                             None, tb)
    try:
        for rid in ("r0", "r1"):
            InputQueue(q).enqueue_tensor(rid, np.ones(3, np.float32))
        assert serving.serve_once() == 2
    finally:
        serving.shutdown()
    got = read_scalars(tb)
    assert [s for s, _ in got["Serving Throughput"]] == [2]
    assert got["Serving Throughput"][0][1] > 0
    assert got["Total Records Number"] == [(2, 2.0)]
